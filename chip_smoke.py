"""Smoke run of the PyTorch/CUDA port (mafed_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each printing one JSON line:
  1. device: the card's name and power limit (nvidia-smi), torch and CUDA versions;
  2. build: compiles csrc/flash_attn.cu and csrc/flash_attn_f32.cu with nvcc
     for sm_90a into one library and prints the registers and spill bytes
     (-Xptxas -v) and the HGMMA, UTMALDG, FFMA and HMMA instruction counts
     (cuobjdump -sass, where the toolkit has it) of each instantiation: the
     three bf16 kernels at head_dim 64, 96, 128 and 256 and the three wide
     kernels (every multiple of 128 from 384 on: the forward one CTA a query
     tile and a piece of up to 512 columns, dK/dV and dQ a grid axis over
     128-column output slices), fifteen TMA + wgmma kernels that may lack
     neither; and the float32 kernels (the forward one slice of all of
     head_dim up to 512: an instantiation at each of 64, 96 and 128 and one
     at 512 for every head_dim above; the dK/dV and dQ kernels every
     head_dim at run time, at 128-column slices), six 3xTF32 mma.sync
     kernels (HMMA of the TF32 kind only, no HGMMA); none may spill;
  3. kernels: the three flash kernels against their plain PyTorch versions on
     the card, in bf16, at the shapes of the 410M window and CE window (and
     EVA-02 shapes), at pretraining's ([128, 16, 356, 64], right padding of
     a different length in each row, and its tower at 128 images), at the
     1B model's (heads of 256: its CE pass, CE window, student pass and
     decode prefill), at 1.4B's (heads of 128: the same four) and at the
     GPT-NeoX-20B-width decoder's (64 heads of 96: its CE and student
     passes), at the regrouped decoders' (1B as 4 heads of 512: its CE and
     student passes and decode prefill; the 20B width as 16 heads of 384:
     its CE and student passes), causal cases at 640 and 1024 (the slice
     loop past four slices; the wide forward's two pieces), at a
     tensor-parallel rank's (its heads: 4 of
     256 at 1B, 8 of 64 at 410M), and in 65- and 129-token cases across the tile edges, a
     small unaligned case with fully-masked rows at every head_dim, a
     non-causal unmasked one at 96, 128, 384 and 512 and a small unaligned
     right-padded one; and their times at each head_dim's CE shape and at
     pretraining's beside the plain versions, the bound and
     torch.nn.functional.scaled_dot_product_attention (a yardstick only: its
     forward for the forward kernel, its whole backward, which also computes
     dq, for each backward kernel); then every case again at float32, the
     float32 kernels against the plain versions at float32 (F32_ATOL), and
     their times at each head_dim's CE shape beside their bound (the
     larger of the bytes at 4 an element and the kept pairs' products in
     3xTF32 at the tensor cores' TF32 rate, the card's least time for
     float32-accurate products; the CUDA-core bound, the products at the
     card's float32 rate outside the tensor cores, beside it) and SDPA at
     float32 with TF32 off on the backend it takes; then the forward at
     96, 128 and 256, the wide forward at 384 and 512 and dK/dV at 96 and
     256 beyond those cases (query lengths from 1 to 336, 577 keys, two
     launches bit-equal, the whole backward from the kernels' forward; their
     ms against SDPA's and their bounds: the fwd_d*, fwd_wide_d* and
     bwd_dkv_d* lines); then
     one shape that the JAX package sends to xla_attention (32 heads of 80,
     Pythia-2.8B's width): dot_product_attention equal to masked_attention,
     no launch;
  4. reference: one window of a tiny model on the card (CUDA kernels) against
     the same window on the CPU (plain versions), and that model's tower
     features and KV-cache prefill logits (head_dim-64 tower; a decoder with
     heads of 64, then of 96, 128, 256, 384 and 512); then the head_dim-64
     model's CE window, EWC window, train step, distill step, Fisher accumulator and
     adaptive-weight sums, card against CPU; and the rows the device vision
     table (bfloat16 and int8) and the teacher table gather, card against
     CPU, bit for bit;
  5. pretrain, pretrain_resume, pretrain_to_cl (the first model phases: an
     update at batch 128 takes ~75 of the card's 80 GB): captioning
     pretraining through mafed_tpu_torch.pretrain_vlpythia.train(argv) at
     full width and depth (the defaults of ModelArguments and
     PretrainConfig: 410M + EVA-02-L from the seed, batch 128, text 100,
     AdamW, bf16) over 512 + 128 captions of PNG images it writes (every
     4th a Visual-Genome region): 4 updates, evals and checkpoints at 2 and
     4, and checkpoint-final; launches 288 / 96 / 96, the logged losses,
     the checkpoints' files and their rotation asserted; the update's ms,
     examples/s, MFU, peak memory and seconds per checkpoint. Then a fresh
     trainer resumed from checkpoint-2: its checkpoint-final equal to the
     first run's bit for bit. Then cl_sequence_default's command line with
     --model_name <pretrain out>/checkpoint-final: the trainer's initial
     model equal to the checkpoint bit for bit, launches 572 / 144 / 144;
  6. window: three fused MAFED windows of VL-Pythia-410M at full width and
     depth (random seeded weights, cached-patch shapes of the bench), with the
     kernel launch counts of that run; window_f32 (after train_steps): the
     same three windows from the same weights at compute_dtype float32
     (118 / 48 / 48 launches a window, all of the float32 kernels), their
     metrics against window's, MFU against the card's float32 peak, then one
     small window through the kernels against the plain versions at float32
     (PLAIN_F32_LIMITS);
  7. decode: greedy KV-cache decode of VL-Pythia-410M + EVA-02-L at full width
     and depth (bf16 weights from a seed; batch 32, text 64 with 16 left-padded
     positions, 10 new tokens), from uint8 pixels through the tower and from
     the tower's cached patch features, each timed over 6 batches after a
     warm-up with batch i+1 dispatched before batch i is read, with the kernel
     launch counts of each route; the emitted tokens checked against a
     no-cache forward; then validate_vqa over 3 synthetic batches;
  8. train_steps: the other training paths of VL-Pythia-410M at full width and
     depth, each from the same seeded weights and microbatches of 16 (text 80,
     20 left-padded positions, an 8-token answer, uint8 pixels and the tower's
     features of them): CE and EWC windows of 4 microbatches (the EWC
     importances from the Fisher accumulator over 2 batches), the
     per-microbatch cadence under MultiSteps(4) (4 train steps; 3 train steps
     and a distill step), the MAFED window fused, unfused and from pixels, and
     the adaptive-weight sums; each path's times, launches and checks, and two
     cross-path checks of the first losses;
  9. window_1b, ce_window_1b, decode_1b: VL-Pythia-1B (hidden 2048, 16
     layers, 8 heads of 256, the trainer's default model) at full width and
     depth, the 410M models freed first: three fused MAFED windows at phase
     6's shapes (launches 78 / 32 / 32 a window, all at head_dim 256), three
     CE windows of 4 x 16 (32 / 16 / 16), and phase 7's decode with the
     EVA-02-L tower (40 forward launches a batch from pixels, 24 at head_dim
     64 and 16 at 256; 16 from patches); then window_1_4b, ce_window_1_4b,
     decode_1_4b: the same three at VL-Pythia-1.4B (EleutherAI/pythia-1.4b:
     hidden 2048, 24 layers, 16 heads of 128, intermediate 8192; 118 / 48 /
     48, 48 / 24 / 24 and 24 at 64 + 24 at 128 a batch from pixels, 24 from
     patches); then window_d96: three MAFED windows of a decoder at
     EleutherAI/gpt-neox-20b's widths (hidden 6144, 64 heads of 96,
     intermediate 24576, vocab 50432) cut to 4 of its 44 layers (18 / 8 / 8
     a window at 96); then window_d512 and decode_d512: VL-Pythia-1B's
     decoder regrouped as 4 heads of 512 (78 / 32 / 32 a window at 512; 24
     at 64 + 16 at 512 a batch from pixels, 16 from patches), and
     window_d384: the 20B-width cut regrouped as 16 heads of 384 (18 / 8 / 8
     at 384). After the timed windows of window_1_4b, window_d96,
     window_d512 and window_d384, one window of 4 x 2 rows from the same
     starting weights through the kernels and through the plain versions
     on the card: losses and grad
     norm within PLAIN_WINDOW_RTOL, the gradients of every layer's attention
     weights (q, k, v rows of query_key_value, and dense) in norm within
     PLAIN_ATTN_NORM_RTOL and in difference within PLAIN_ATTN_DIFF_RTOL;
 10. cl_sequence: the port's continual-learning trainer through its entry
     points (parse_with_config over config/train-vqa-base-cl-vlpythia.json,
     ContinualLearningTrainer.main) on the shipped config's model,
     config/vlpythia-base.json (VL-Pythia-410M + EVA-02-L, full width and
     depth, random weights from the seed): two tasks of 128 train and 32 val
     synthetic questions, one epoch each, featdistill (MAFED) with fused
     windows of 4 x 16 and a replay batch every 4th, the vision cache primed
     through the port's tower, with --device_vision_table_mb 0
     --teacher_state_cache off (streamed features, the in-step teacher);
     asserts the accuracy matrix and BWT, the run's files, a resume bundle
     after each task, a bit-for-bit checkpoint reload, an unchanged teacher,
     the windows each task ran and the flash launches computed from the
     config, by head_dim and by dtype; prints the seconds of each stage and
     each task's train examples/s; then cl_sequence_f32: the same with
     --compute_dtype float32, its windows' launches (332 / 144 / 144) of the
     float32 kernels and eval's and the tower's (240 / 0 / 0) of the bf16
     ones;
 11. cl_sequence_default: the same command line without those two switches,
     the shipped config's defaults: the features in a device table (tier,
     rows and MB asserted), the teacher's states primed after task 0 into a
     device table (examples and MB asserted), the MAFED windows without
     their teacher pass and priming's forwards in the launches; its accuracy
     matrix equal to cl_sequence's and its losses within SEQUENCE_LOSS_RTOL;
 12. cl_resume: the default sequence preempted after task 1's first window
     (Preempted, exit code 143, a mid-epoch bundle), then restarted with
     --resume_from_checkpoint: its {task}_best checkpoints and accuracy
     matrix equal to cl_sequence_default's bit for bit, the launches of each
     half as computed; the seconds of each half and of each bundle saved.
 13. image_engine (host only, before the model phases): whether the C++
     image engine built (and why not), 250 COCO-sized JPEG and PNG files
     decoded through it and through PIL (seconds, largest and mean pixel
     difference), and a pretrain batch of 128 captions through the loader
     with MAFED_NATIVE_IMAGES=1 and =0;
 14. remat_policies (after train_steps): five 410M MAFED windows under ""
     and each named remat policy from one snapshot of the weights: losses
     and grad norms against full recompute's, ms, peak GB, launches;
 15. clip_eval: VL-Pythia-410M + CLIP-L/14-336 (577 tokens) at full width
     and depth: greedy decode at batch 32 from uint8 pixels (24 non-causal
     forwards at 577 + 24 causal a batch), the tower's hidden_states[-2]
     against the port's float32 CPU run, validate_vqa, and the tower's flash
     forward at [32, 16, 577, 64] timed;
 16. cka_sweep (inside cl_sequence_default's directory): analysis.sweep.main
     over that run at --max_batches 2: 25 layers, values in [0, 1], launches,
     CKA(a, a) = 1 on the card;
 17. profile (last): the shipped config on one task of 384 questions, plain,
     with --profile_dir and plain again: the trace names the three kernels;
     the profiled fit's seconds against the plain ones.
 18. multiprocess (after cl_resume): data parallelism over torch.distributed,
     two ranks of this script (--mp-worker) sharing cuda:0 over gloo (the
     machine has one card; NCCL refuses two ranks on one), each failure or
     timeout of a rank failing the phase; at full width, cut in depth
     (MP_LAYERS of the 410M model's 24 layers), each check against one
     process at the same depth: process_reduce_sum on known values; phase
     window's three 410M MAFED windows on 8 of the 16 rows a rank against
     one process on all 16 (the ranks bit-equal; metrics within bf16's
     resolution; parameters within 5 % of one process's update length;
     5 L - 2 / 2 L / 2 L launches a window on each rank), beside the spread
     of one process on the rows reordered; a SIGTERM to rank 1 alone
     stopping both after the same window; cl_sequence_default's sequence
     (with no epoch-end bundles) once in one process (cl_reference), then
     over both ranks (the caches primed by both into one directory), its
     accuracy matrix beside the one-process one and its losses within
     bf16's resolution, then preempted by the countdown after 2 updates and
     resumed, bit-equal
     (these runs write only the bundle: no task checkpoint); two pretraining
     updates at a global batch of 64 (the pair cannot hold 128) against one
     process. The NCCL windows run on two cards; on one the phase prints
     {"phase": "multiprocess_nccl", "run": false, "cards": 1}.
 19. tensor_parallel (after multiprocess): the (data, model) grid of
     core/mesh.py, ranks of this script on cuda:0 over gloo as in phase
     multiprocess: VL-Pythia-1B at full width, cut to TP_WINDOW_LAYERS of
     its 16 layers, under mesh_shape [1, 2] (4 heads of 256 a rank), phase
     window_1b's three MAFED windows against one process on the same
     weights, rows and depth (metrics within bf16's resolution, the
     gathered parameters within 5 % of one process's update length and
     2.02 lr an update, the replicated parameters bit-equal on the ranks,
     5 L - 2 / 2 L / 2 L launches a window a rank, ms a window and peak GB a
     rank); phase multiprocess's sequence (its model cut to MP_LAYERS) under
     [2, 2] (four ranks), its accuracy matrix equal to that phase's one
     process's and its losses within bf16's resolution, the best checkpoint, read by
     rank 0 as one process reads it, bit-equal to the gathered model, then a SIGTERM
     to rank 1 alone stopping all four at one update and the resume
     bit-equal to the uninterrupted run; two pretraining updates at a
     global 64 under [1, 2] (the windows' two ranks) against phase
     multiprocess's one process. The
     1B windows run over NCCL on two cards; on one the phase prints
     {"phase": "tensor_parallel_nccl", "run": false, "cards": 1}.
The kernel cases include the CLIP tower's [32, 16, 577, 64] (non-causal,
577 = 9 x 64 + 1) and its decode prefill (640, causal, 16 padded keys).
Every phase line ends with "clock_s", the script's seconds at its end, and
"phase_s", its seconds since the phase line before it.
Then the kernel summary line (one entry per bf16 kernel and head_dim that
launched on the main path, and one per float32 kernel with its times at
every head_dim), the
nvidia-smi line, and as the last line {"ok": true, "device": {...}}. Any
failure raises and exits non-zero; without a CUDA device, or without the
package beside it, the script exits non-zero before printing anything.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from mafed_tpu_torch.core import preempt
from mafed_tpu_torch.core.config import (
    ModelConfig, TrainConfig, VisionConfig, build_arg_parser, model_config_for_preset, parse_with_config,
)
from mafed_tpu_torch.data import teacher_cache as ttc
from mafed_tpu_torch.data import vision_table as vt
from mafed_tpu_torch.data.images import make_normalizer, prep_pixels, synthetic_image
from mafed_tpu_torch.data.tokenizer import ByteTokenizer
from mafed_tpu_torch.evaluation.decode import make_greedy_decoder
from mafed_tpu_torch.evaluation.validate import validate_vqa
from mafed_tpu_torch.kernels import attention as A
from mafed_tpu_torch.kernels import build
from mafed_tpu_torch.models import clip_vit, gpt_neox
from mafed_tpu_torch.models import vl_pythia as V
from mafed_tpu_torch.models.vl_pythia import init_model
from mafed_tpu_torch.optim.optimizer import MultiSteps, build_optimizer, set_schedule
from mafed_tpu_torch.trainer import continual
from mafed_tpu_torch.training.flops import (
    ce_example_flops, framework_decode_flops_per_example, framework_window_flops, mfu,
)
from mafed_tpu_torch.training.step import (
    distillation_layers, make_adaptive_weights_fn, make_ce_window_step, make_distill_step, make_ewc_fisher_fn,
    make_mafed_window_step, make_train_step,
)
from mafed_tpu_torch.training.train_state import TrainState, make_teacher, trainable_parameters
from mafed_tpu_torch.utils.checkpoint import load_task_checkpoint, save_task_checkpoint

# Tolerances of the kernel checks (bf16): the tiled kernels round p to bf16
# relative to a running row maximum, the dense plain versions relative to the
# final one, so single elements differ by a few bf16 ulps.
ATOL, RTOL = 2e-2, 2e-2
LSE_ATOL = 1e-4  # lse is f32 in both
# The float32 kernels against the plain versions at float32: both multiply
# float32 operands in float32 (TF32 off), in other orders (online softmax over
# 64-key tiles, FMA chains against cuBLAS's blocking), so they differ by
# float32 rounding only, a few 1e-6 at these magnitudes
F32_ATOL = F32_RTOL = 1e-4
F32_LSE_ATOL = 1e-5

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
BF16_FLOPS_PER_S = 989e12  # H100 SXM dense bf16
FP32_FLOPS_PER_S = 67e12  # H100 SXM dense float32 outside the tensor cores
TF32_FLOPS_PER_S = 495e12  # H100 SXM dense TF32 on the tensor cores; a 3xTF32 product takes three

SM90 = "sm90 tma+wgmma"
# the bf16 forward at 96, 128 and 256 (flash_attn.cu fwd_cta): two warpgroups a CTA with a query tile each,
# each score tile formed once, P V in one m64nDk16 a k-step; at 96 unpadded [64][96] tiles (three 32-column
# panels, 64-byte swizzle)
SM90_FWD_SPLIT = {96: "sm90 tma+wgmma, unpadded 64-byte-swizzled tiles, S once, two query tiles a CTA",
                  128: "sm90 tma+wgmma, S once, P V m64n128k16, two query tiles a CTA",
                  256: "sm90 tma+wgmma, S once, P V m64n256k16, two query tiles a CTA"}
# the bf16 wide forward (flash_attn.cu flash_fwd_wide_kernel): one CTA a query tile and a piece of up to 512
# columns, one warpgroup a 128-column slice, Q loaded once, each score tile formed once (split over D, the
# partials summed through shared memory)
SM90_FWD_WIDE = ("sm90 tma+wgmma, one CTA a query tile and up to 512 columns, a warpgroup a 128-column slice, "
                 "Q once, S once split over D (partials summed in shared memory), P V m64n128k16")
# the float32 kernels' designs: all three in 3xTF32 on the tensor cores, the forward's score tile formed once
# over all of head_dim (one CTA a query tile and up to 512 output columns)
SM90_F32 = {"flash_fwd": "sm90 3xtf32 mma.sync, score tile once over head_dim, cp.async",
            "flash_bwd_dkv": "sm90 3xtf32 mma.sync, cp.async",
            "flash_bwd_dq": "sm90 3xtf32 mma.sync, cp.async"}
# the bf16 dK/dV at 96 and 256 (flash_attn.cu dkv_cta): at 96 unpadded tiles, at 256 two warpgroups that split
# each score tile's queries and exchange P^T and dS^T through shared memory
SM90_DKV_CTA = {96: "sm90 tma+wgmma, unpadded 64-byte-swizzled tiles, dV and dK m64n96k16",
                256: "sm90 tma+wgmma, 2 warpgroups split each score tile's queries (m64n32k16), P^T and dS^T "
                     "exchanged in bf16 through shared memory, dK and dV m64n128k16"}
# name (its CUDA kernel is name + "_kernel"): (the TPU kernel it replaces, its design)
KERNELS = {
    "flash_fwd": ("mafed_tpu/kernels/attention.py:81", SM90),
    "flash_bwd_dkv": ("mafed_tpu/kernels/attention.py:230", SM90),
    "flash_bwd_dq": ("mafed_tpu/kernels/attention.py:294", SM90),
}


_START = time.perf_counter()
_CLOCK = [0.0]  # the script's clock at the last phase line


def emit(obj) -> None:
    """Print one JSON line; a phase's line also gets the script's clock at
    its end (clock_s) and the seconds since the phase line before it
    (phase_s)."""
    if "phase" in obj:
        now = time.perf_counter() - _START
        obj = {**obj, "clock_s": now, "phase_s": now - _CLOCK[0]}
        _CLOCK[0] = now
    print(json.dumps(obj), flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "device", "nvidia_smi": smi, "name": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return smi


def phase_build() -> None:
    start = time.perf_counter()
    build.load_library()
    seconds = time.perf_counter() - start
    log = build.build_log()
    resources = build.kernel_resources(log)
    sass = build.sass_counts()
    warnings = [line.strip() for line in log.splitlines() if "warning" in line.lower()]
    emit({"phase": "build", "seconds": seconds, "instantiations": list(build.INSTANTIATIONS), "ptxas": resources,
          "sass": sass, "warnings": warnings})
    for kernel in build.INSTANTIATIONS:
        res = resources.get(kernel, {})
        if res.get("spill_store_bytes") != 0 or res.get("spill_load_bytes") != 0:
            raise AssertionError(f"{kernel}: spills or no ptxas report: {res}")
    # the bfloat16 kernels are TMA + wgmma kernels; the float32 kernels 3xTF32 mma.sync kernels with no wgmma
    faults = build.sass_faults(sass) if sass is not None else []
    if faults:
        raise AssertionError(f"SASS: {faults}")


def launches_by_dim() -> dict:
    """{head_dim: {kernel: launches}} since the last reset, at the head_dims
    that launched."""
    return {d: dict(c) for d, c in A.LAUNCHES_BY_HEAD_DIM.items()}


def at_head_dim(d: int, per_kernel: dict) -> dict:
    """{head_dim: {kernel: launches}} with `per_kernel` at d and none at the
    other head_dims, as launches_by_dim() reads after such a run."""
    return _sum_launches([{d: per_kernel}])


def _sum_launches(parts) -> dict:
    """The sum of launch counts by head_dim (a rank's come through JSON, keyed
    by str), without the head_dims at which none launched, as
    launches_by_dim() leaves them out."""
    parts = [{int(d): c for d, c in p.items()} for p in parts]
    dims = {d for p in parts for d, c in p.items() if any(c.values())}
    return {d: {k: sum(p[d][k] for p in parts if d in p) for k in A.LAUNCHES} for d in sorted(dims)}


def _row_lengths(b: int, t: int, low: int) -> torch.Tensor:
    """Kept keys per row for ragged right padding: t, then lengths spread
    over [low, t] (row i keeps t - (37 i mod (t - low + 1)))."""
    return t - (torch.arange(b, device="cuda") * 37) % (t - low + 1)


def _qkv(gen, b, h, t, pad, empty_sample, d=64, dtype=torch.bfloat16):
    """q, k, v, do (bf16, or `dtype`) and the key mask of a case: `pad` is a
    key range (start, end) masked in every row, or ("right", low) for right
    padding of a different length in each row (a caption batch: keys past
    the row's length masked, at least `low` kept)."""
    q, k, v, do = (torch.randn(b, h, t, d, generator=gen, device="cuda").to(dtype) for _ in range(4))
    mask = torch.ones(b, t, dtype=torch.int32, device="cuda")
    if pad is not None and pad[0] == "right":
        mask = (torch.arange(t, device="cuda")[None] < _row_lengths(b, t, pad[1])[:, None]).to(torch.int32)
    elif pad is not None:
        mask[:, pad[0]:pad[1]] = 0
    if empty_sample:
        mask[-1] = 0
    return q, k, v, do, (mask if pad is not None or empty_sample else None)


def _err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


# (name, batch, heads, seq, head_dim, causal, padded key range or ("right", least kept keys), all-masked last sample)
KERNEL_CASES = [
    # pretraining's decoder: 256 vision + 100 caption tokens, right-padded per row (356 = 5 x 64 + 36)
    ("pretrain_410m", 128, 16, 356, 64, True, ("right", 257), False),
    ("small_unaligned_right_padded", 3, 2, 77, 64, True, ("right", 1), False),
    ("eva02_tower_b128", 128, 16, 257, 64, False, None, False),  # pretraining's tower
    ("ce_410m", 48, 16, 336, 64, True, (256, 276), False),
    ("ce_window_410m", 64, 16, 336, 64, True, (256, 276), False),  # the CE window's 4 x 16 rows
    ("student_410m", 16, 16, 336, 64, True, (256, 276), False),
    ("eva02_noncausal", 16, 16, 257, 64, False, None, False),
    ("eva02_tower_b32", 32, 16, 257, 64, False, None, False),  # the decode's tower
    ("eva02_tower_b64", 64, 16, 257, 64, False, None, False),  # a pixels-route window's 48 + 16 images
    ("decode_prefill_b32", 32, 16, 320, 64, True, (256, 272), False),  # the decode's prefill
    ("clip_tower_b32", 32, 16, 577, 64, False, None, False),  # CLIP-L/14-336: 577 = 9 x 64 + 1 tokens
    ("clip_decode_prefill_b32", 32, 16, 640, 64, True, (576, 592), False),  # 576 patches + 64 text, 16 padded
    ("causal_129_padded", 8, 4, 129, 64, True, (0, 7), False),
    ("small_unaligned_empty_rows", 3, 2, 77, 64, True, (0, 3), True),
    ("ce_1b", 48, 8, 336, 256, True, (256, 276), False),  # VL-Pythia-1B: 8 heads of 256
    ("ce_window_1b", 64, 8, 336, 256, True, (256, 276), False),
    ("student_1b", 16, 8, 336, 256, True, (256, 276), False),
    ("decode_prefill_1b", 32, 8, 320, 256, True, (256, 272), False),
    ("causal_129_padded_d256", 8, 4, 129, 256, True, (0, 7), False),
    ("small_unaligned_empty_rows_d256", 3, 2, 77, 256, True, (0, 3), True),
    # VL-Pythia-1.4B (16 heads of 128): its CE pass, CE window, student pass and decode prefill
    ("ce_1_4b", 48, 16, 336, 128, True, (256, 276), False),
    ("ce_window_1_4b", 64, 16, 336, 128, True, (256, 276), False),
    ("student_1_4b", 16, 16, 336, 128, True, (256, 276), False),
    ("decode_prefill_1_4b", 32, 16, 320, 128, True, (256, 272), False),
    ("causal_65_padded_d128", 8, 4, 65, 128, True, (0, 7), False),
    ("causal_129_padded_d128", 8, 4, 129, 128, True, (0, 7), False),
    ("small_unaligned_empty_rows_d128", 3, 2, 77, 128, True, (0, 3), True),
    ("noncausal_unmasked_d128", 16, 16, 257, 128, False, None, False),
    # the decoder at GPT-NeoX-20B's width (64 heads of 96): its CE and student passes
    ("ce_neox20b", 48, 64, 336, 96, True, (256, 276), False),
    ("student_neox20b", 16, 64, 336, 96, True, (256, 276), False),
    ("causal_65_padded_d96", 8, 4, 65, 96, True, (0, 7), False),
    ("causal_129_padded_d96", 8, 4, 129, 96, True, (0, 7), False),
    ("small_unaligned_empty_rows_d96", 3, 2, 77, 96, True, (0, 3), True),
    ("noncausal_unmasked_d96", 16, 16, 257, 96, False, None, False),
    # the wide kernels: 1B's decoder as 4 heads of 512 (its CE and student passes and decode prefill)
    # and the 20B-width decoder as 16 heads of 384 (its CE and student passes)
    ("ce_1b_d512", 48, 4, 336, 512, True, (256, 276), False),
    ("student_1b_d512", 16, 4, 336, 512, True, (256, 276), False),
    ("decode_prefill_1b_d512", 32, 4, 320, 512, True, (256, 272), False),
    ("causal_65_padded_d512", 8, 4, 65, 512, True, (0, 7), False),
    ("causal_129_padded_d512", 8, 4, 129, 512, True, (0, 7), False),
    ("small_unaligned_empty_rows_d512", 3, 2, 77, 512, True, (0, 3), True),
    ("noncausal_unmasked_d512", 16, 4, 257, 512, False, None, False),
    ("ce_neox20b_d384", 48, 16, 336, 384, True, (256, 276), False),
    ("student_neox20b_d384", 16, 16, 336, 384, True, (256, 276), False),
    ("causal_65_padded_d384", 8, 4, 65, 384, True, (0, 7), False),
    ("causal_129_padded_d384", 8, 4, 129, 384, True, (0, 7), False),
    ("small_unaligned_empty_rows_d384", 3, 2, 77, 384, True, (0, 3), True),
    ("noncausal_unmasked_d384", 16, 16, 257, 384, False, None, False),
    # five and eight slices: the slice loop past the four of 512, the wide forward's two pieces (its score in
    # rounds of 3 and 4 slices)
    ("causal_200_padded_d640", 2, 2, 200, 640, True, (0, 5), False),
    ("causal_130_padded_d1024", 2, 2, 130, 1024, True, (0, 5), False),
    # phase multiprocess: a rank's half of the 410M window (its CE stack of 3 x 8 rows, its student
    # and teacher passes) and of the pretraining update at a global 64
    ("mp_ce_410m_rank", 24, 16, 336, 64, True, (256, 276), False),
    ("mp_student_410m_rank", 8, 16, 336, 64, True, (256, 276), False),
    ("mp_pretrain_410m_rank", 32, 16, 356, 64, True, ("right", 257), False),
    # phase tensor_parallel: a rank's heads (M = 2): the 1B window under [1, 2] (its CE stack of
    # 3 x 16 rows, its student and teacher passes), the 410M CL windows under [2, 2] (3 x 8 and 8
    # rows) and the pretraining update at a global 64 under [1, 2]
    ("tp_ce_1b_rank", 48, 4, 336, 256, True, (256, 276), False),
    ("tp_student_1b_rank", 16, 4, 336, 256, True, (256, 276), False),
    ("tp_ce_410m_rank", 24, 8, 336, 64, True, (256, 276), False),
    ("tp_student_410m_rank", 8, 8, 336, 64, True, (256, 276), False),
    ("tp_pretrain_410m_rank", 64, 8, 356, 64, True, ("right", 257), False),
]
# what SDPA's timed call computes beside each kernel's
LIBRARY_COVERS = {"flash_fwd": "o", "flash_bwd_dkv": "dq+dk+dv", "flash_bwd_dq": "dq+dk+dv"}


def check_case(gen, name, b, h, t, d, causal, pad, empty, dtype=torch.bfloat16) -> dict:
    """One case, the three kernels against the plain versions at `dtype`
    (bf16 at ATOL / RTOL, f32 at F32_ATOL / F32_RTOL), at the models' scale
    head_dim^-0.5; emitted, and returns the largest error of each kernel
    and of each of dq, dk and dv."""
    atol, rtol, lse_atol = (ATOL, RTOL, LSE_ATOL) if dtype == torch.bfloat16 else (F32_ATOL, F32_RTOL, F32_LSE_ATOL)
    scale = d ** -0.5
    q, k, v, do, mask = _qkv(gen, b, h, t, pad, empty, d, dtype)
    o, lse = A.flash_forward(q, k, v, mask, causal, scale)
    o_p, lse_p = A.flash_forward_plain(q, k, v, mask, causal, scale)
    fin = torch.isfinite(lse_p)
    if not torch.equal(torch.isinf(lse), ~fin):
        raise AssertionError(f"{name}: empty rows differ between kernel and plain version")
    torch.testing.assert_close(o.float(), o_p.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(lse[fin], lse_p[fin], atol=lse_atol, rtol=0)
    delta = (do.float() * o_p.float()).sum(-1)
    dk, dv = A.flash_bwd_dkv(q, k, v, mask, do, lse_p, delta, causal, scale)
    dq = A.flash_bwd_dq(q, k, v, mask, do, lse_p, delta, causal, scale)
    dq_p, dk_p, dv_p = A.flash_backward_plain(q, k, v, mask, o_p, lse_p, do, causal, scale)
    for got, want in ((dq, dq_p), (dk, dk_p), (dv, dv_p)):
        if got.dtype != dtype:
            raise AssertionError(f"{name}: a gradient of dtype {got.dtype} from {dtype} inputs")
        torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)
    torch.cuda.synchronize()
    grad_err = {"dq": _err(dq, dq_p), "dk": _err(dk, dk_p), "dv": _err(dv, dv_p)}
    case_err = {
        "flash_fwd": max(_err(o, o_p), (lse[fin] - lse_p[fin]).abs().max().item()),
        "flash_bwd_dkv": max(grad_err["dk"], grad_err["dv"]),
        "flash_bwd_dq": grad_err["dq"],
    }
    emit({"phase": "kernels", "case": name, "dtype": str(dtype).split(".")[1], "shape": [b, h, t, d],
          "causal": causal, "empty_rows": int((~fin).sum().item()), "max_abs_err": {**case_err, **grad_err},
          "atol": atol, "rtol": rtol, "lse_atol": lse_atol})
    return {**case_err, **grad_err}


def phase_kernels(gen):
    """Every case, kernel against plain version, in bf16 and then again in
    f32; then the times at each model's CE shape, in both. Returns
    ({(kernel, head_dim): largest error}, {head_dim: timing at its CE
    shape}) for the bf16 kernels, then the same two for the f32 ones."""
    errs, errs_f32 = {}, {}
    for dtype, into in ((torch.bfloat16, errs), (torch.float32, errs_f32)):
        for name, b, h, t, d, causal, pad, empty in KERNEL_CASES:
            for kname, e in check_case(gen, name, b, h, t, d, causal, pad, empty, dtype).items():
                into[kname, d] = max(into.get((kname, d), 0.0), e)
    emit({"phase": "kernels", "case": "f32_largest_errors", "atol": F32_ATOL, "rtol": F32_RTOL,
          "lse_atol": F32_LSE_ATOL,
          "max_abs_err": {k: {d: e for (kn, d), e in sorted(errs_f32.items()) if kn == k}
                          for k in (*KERNELS, "dq", "dk", "dv")}})

    timing = {64: kernel_timing(gen, "timing_ce_410m", 48, 16, 336, 64),
              96: kernel_timing(gen, "timing_ce_neox20b", 48, 64, 336, 96),
              128: kernel_timing(gen, "timing_ce_1_4b", 48, 16, 336, 128),
              256: kernel_timing(gen, "timing_ce_1b", 48, 8, 336, 256),
              384: kernel_timing(gen, "timing_ce_neox20b_d384", 48, 16, 336, 384),
              512: kernel_timing(gen, "timing_ce_1b_d512", 48, 4, 336, 512),
              "pretrain": kernel_timing(gen, "timing_pretrain_410m", 128, 16, 356, 64, pad=("right", 257))}
    # a tensor-parallel rank's CE pass (M = 2): 1B under [1, 2], 410M under [2, 2]
    timing["tp_1b"] = kernel_timing(gen, "timing_tp_ce_1b_rank", 48, 4, 336, 256)
    timing["tp_410m"] = kernel_timing(gen, "timing_tp_ce_410m_rank", 24, 8, 336, 64)
    for case, b, h, t, d, causal, pad in (("timing_decode_tower", 32, 16, 257, 64, False, None),
                                          ("timing_decode_prefill", 32, 16, 320, 64, True, (256, 272)),
                                          ("timing_ce_window", 64, 16, 336, 64, True, (256, 276)),
                                          ("timing_window_tower_b64", 64, 16, 257, 64, False, None),
                                          ("timing_decode_prefill_1b", 32, 8, 320, 256, True, (256, 272)),
                                          ("timing_ce_window_1b", 64, 8, 336, 256, True, (256, 276)),
                                          ("timing_decode_prefill_1_4b", 32, 16, 320, 128, True, (256, 272)),
                                          ("timing_decode_prefill_1b_d512", 32, 4, 320, 512, True, (256, 272))):
        emit({"phase": "kernels", "case": case, **_fwd_timing(gen, b, h, t, d, causal, pad)})
    # the f32 kernels at each head_dim's CE shape (the bound: float32-accurate products in 3xTF32 on the
    # tensor cores, or the bytes; the CUDA-core bound beside it)
    timing_f32 = {d: kernel_timing(gen, f"timing_f32_ce_{d}", 48, h, 336, d, dtype=torch.float32)
                  for d, h in ((64, 16), (96, 64), (128, 16), (256, 8), (384, 16), (512, 4))}
    for d in (*SM90_FWD_SPLIT, *WIDE_FWD_CHECKED):
        errs["flash_fwd", d] = max(errs["flash_fwd", d], check_fwd_query_split(gen, d, timing[d]))
    for d in SM90_DKV_CTA:
        errs["flash_bwd_dkv", d] = max(errs["flash_bwd_dkv", d], check_bwd_dkv(gen, d, timing))
    check_xla_routing(gen)
    return errs, timing, errs_f32, timing_f32


# the forward at 96, 128 and 256 beyond KERNEL_CASES: (batch, heads, q_len, kv_len, masked key range) of
# non-causal calls with more keys than queries (CLIP-L/14-336's 577 keys; a one-row last query tile; a masked
# last key tile; an odd count of query tiles)
SPLIT_NONCAUSAL_CASES = [(4, 16, 129, 577, (500, 577)), (4, 16, 65, 577, (3, 40)), (2, 8, 320, 577, (560, 577))]
# (batch, heads) of each head_dim's CE shape [48, H, 336, D]
CE_HEADS = {96: 64, 128: 16, 256: 8, 384: 16, 512: 4}
# the wide forward (flash_fwd_wide_kernel) checked and timed as the forwards at 96, 128 and 256 are: its lines
# are fwd_wide_d*
WIDE_FWD_CHECKED = (384, 512)


def check_fwd_query_split(gen, d: int, timing_d: dict) -> float:
    """flash_fwd_kernel<d> at 96, 128 or 256 (two query tiles a CTA, fwd_cta),
    or the wide forward at 384 or 512 (one CTA a query tile, each score tile
    formed once; lines named fwd_wide_d<d>), beyond KERNEL_CASES: the
    non-causal calls of SPLIT_NONCAUSAL_CASES against the plain version;
    (o, lse) bit-equal across two launches at the CE shape and a small one;
    its (o, lse) into the <d> backward kernels against the plain backward; its time at the CE shape against SDPA's
    forward and its bound (emitted, from `timing_d`, kernel_timing's at
    [48, H, 336, d]). Returns the largest |o, lse - plain|."""
    scale, largest = d ** -0.5, 0.0
    line = f"fwd_wide_d{d}" if build.wide_head_dim(d) else f"fwd_d{d}"
    for b, h, tq, tk, masked in SPLIT_NONCAUSAL_CASES:
        q = torch.randn(b, h, tq, d, generator=gen, device="cuda").bfloat16()
        k, v = (torch.randn(b, h, tk, d, generator=gen, device="cuda").bfloat16() for _ in range(2))
        mask = torch.ones(b, tk, dtype=torch.int32, device="cuda")
        mask[:, masked[0]:masked[1]] = 0
        o, lse = A.flash_forward(q, k, v, mask, False, scale)
        o_p, lse_p = A.flash_forward_plain(q, k, v, mask, False, scale)
        torch.testing.assert_close(o.float(), o_p.float(), atol=ATOL, rtol=RTOL)
        torch.testing.assert_close(lse, lse_p, atol=LSE_ATOL, rtol=0)
        err = max(_err(o, o_p), _err(lse, lse_p))
        largest = max(largest, err)
        emit({"phase": "kernels", "case": f"{line}_noncausal", "shape": [b, h, tq, tk, d], "masked": list(masked),
              "max_abs_err": err, "atol": ATOL, "rtol": RTOL, "lse_atol": LSE_ATOL})
    bit_equal = {}
    ce = f"ce_d{d}"
    for name, (b, h, t, pad, causal) in {ce: (48, CE_HEADS[d], 336, (256, 276), True),
                                         "small_unaligned_empty_rows": (3, 2, 77, (0, 3), True)}.items():
        q, k, v, do, mask = _qkv(gen, b, h, t, pad, name.endswith("empty_rows"), d)
        o, lse = A.flash_forward(q, k, v, mask, causal, scale)
        o2, lse2 = A.flash_forward(q, k, v, mask, causal, scale)
        bit_equal[name] = torch.equal(o, o2) and torch.equal(lse, lse2)
        # the forward's (o, lse) into the <d> backward kernels, against the plain forward and backward
        o_p, lse_p = A.flash_forward_plain(q, k, v, mask, causal, scale)
        got = A.flash_backward(q, k, v, mask, o, lse, do, causal, scale)
        want = A.flash_backward_plain(q, k, v, mask, o_p, lse_p, do, causal, scale)
        for label, x, y in zip(("dq", "dk", "dv"), got, want):
            torch.testing.assert_close(x.float(), y.float(), atol=ATOL, rtol=RTOL, msg=lambda m: f"{label}: {m}")
        emit({"phase": "kernels", "case": f"{line}_into_backward_{name}", "shape": [b, h, t, d],
              "max_abs_err": {label: _err(x, y) for label, x, y in zip(("dq", "dk", "dv"), got, want)}})
    if not all(bit_equal.values()):
        raise AssertionError(f"{line}: two launches differ: {bit_equal}")
    ms, sdpa = timing_d["ms"]["flash_fwd"], timing_d["library_ms"]["flash_fwd"]
    emit({"phase": "kernels", "case": f"{line}_against_sdpa", "shape": [48, CE_HEADS[d], 336, d], "ms": ms,
          "sdpa_fwd_ms": sdpa, "ratio_to_sdpa": ms / sdpa, "bound_ms": timing_d["bound_ms"]["flash_fwd"],
          "ratio_to_bound": ms / timing_d["bound_ms"]["flash_fwd"], "bound_by": timing_d["bound_by"]["flash_fwd"],
          "bit_equal": bit_equal})
    return largest


# dK/dV at 96 and 256 (flash_attn.cu dkv_cta) beyond KERNEL_CASES: query lengths from one row to the
# window's 336 (both sides of a tile edge, odd counts of tiles), causal or not, right-padded keys with an
# all-masked sample or no mask
DKV_Q_LENS = (1, 63, 64, 65, 130, 320, 336)
# |dq, dk, dv - plain| of the whole backward from the kernels' forward at the CE shape and a small one: one
# bf16 step at magnitudes 2 to 4 (reported beside the largest errors; the check is ATOL / RTOL)
DKV_BACKWARD_ATOL = 2.0 ** -6


def check_bwd_dkv(gen, d: int, timing: dict) -> float:
    """flash_bwd_dkv_kernel<d> at 96 or 256 (dkv_cta) beyond KERNEL_CASES:
    DKV_Q_LENS causal and not, padded or not, and the non-causal calls of
    SPLIT_NONCAUSAL_CASES (577 keys) against the plain backward at ATOL /
    RTOL; dk, dv bit-equal across two launches at the CE shape and a small
    one; the whole backward there (the forward's (o, lse), dq from
    flash_bwd_dq_kernel<d>) against the plain one (its largest errors beside
    DKV_BACKWARD_ATOL); its
    time at the CE shape against its bound, and the dK/dV + dQ pair's against
    SDPA's whole backward (emitted, from `timing`, kernel_timing's at [48, H,
    336, d]). Returns the largest |dk, dv - plain|."""
    scale, errs = d ** -0.5, {}
    cases = [(4, 4, t, t, causal, padded) for t in DKV_Q_LENS for causal in (True, False) for padded in (True, False)]
    cases += [(b, h, tq, tk, False, masked) for b, h, tq, tk, masked in SPLIT_NONCAUSAL_CASES]
    for b, h, tq, tk, causal, padded in cases:
        if tq == tk:  # right padding, at least half the keys kept, and the last sample all masked
            q, k, v, do, mask = _qkv(gen, b, h, tq, ("right", max(1, tq // 2)) if padded else None, padded, d)
        else:
            q, do = (torch.randn(b, h, tq, d, generator=gen, device="cuda").bfloat16() for _ in range(2))
            k, v = (torch.randn(b, h, tk, d, generator=gen, device="cuda").bfloat16() for _ in range(2))
            mask = torch.ones(b, tk, dtype=torch.int32, device="cuda")
            mask[:, padded[0]:padded[1]] = 0
        o_p, lse_p = A.flash_forward_plain(q, k, v, mask, causal, scale)
        delta = (do.float() * o_p.float()).sum(-1)
        dk, dv = A.flash_bwd_dkv(q, k, v, mask, do, lse_p, delta, causal, scale)
        _, dk_p, dv_p = A.flash_backward_plain(q, k, v, mask, o_p, lse_p, do, causal, scale)
        for label, x, y in (("dk", dk, dk_p), ("dv", dv, dv_p)):
            torch.testing.assert_close(x.float(), y.float(), atol=ATOL, rtol=RTOL,
                                       msg=lambda m: f"dkv<{d}> {[b, h, tq, tk, causal]} {label}: {m}")
        errs[f"{tq}x{tk}_{'causal' if causal else 'noncausal'}_{'padded' if padded else 'unmasked'}"] = max(
            _err(dk, dk_p), _err(dv, dv_p))
    bit_equal, backward = {}, {}
    for name, (b, h, t, pad, empty) in {"ce": (48, CE_HEADS[d], 336, (256, 276), False),
                                        "small_unaligned_empty_rows": (3, 2, 77, (0, 3), True)}.items():
        q, k, v, do, mask = _qkv(gen, b, h, t, pad, empty, d)
        o, lse = A.flash_forward(q, k, v, mask, True, scale)
        delta = (do.float() * o.float()).sum(-1)
        first = A.flash_bwd_dkv(q, k, v, mask, do, lse, delta, True, scale)
        second = A.flash_bwd_dkv(q, k, v, mask, do, lse, delta, True, scale)
        bit_equal[name] = all(torch.equal(x, y) for x, y in zip(first, second))
        o_p, lse_p = A.flash_forward_plain(q, k, v, mask, True, scale)
        got = A.flash_backward(q, k, v, mask, o, lse, do, True, scale)
        want = A.flash_backward_plain(q, k, v, mask, o_p, lse_p, do, True, scale)
        for label, x, y in zip(("dq", "dk", "dv"), got, want):
            torch.testing.assert_close(x.float(), y.float(), atol=ATOL, rtol=RTOL,
                                       msg=lambda m: f"dkv<{d}> whole backward {name} {label}: {m}")
        backward[name] = {label: _err(x, y) for label, x, y in zip(("dq", "dk", "dv"), got, want)}
    emit({"phase": "kernels", "case": f"bwd_dkv_d{d}_cases", "max_abs_err": errs, "atol": ATOL, "rtol": RTOL,
          "bit_equal": bit_equal, "whole_backward_max_abs_err": backward,
          "whole_backward_within": {name: max(e.values()) <= DKV_BACKWARD_ATOL for name, e in backward.items()},
          "whole_backward_reference_atol": DKV_BACKWARD_ATOL})
    if not all(bit_equal.values()):
        raise AssertionError(f"flash_bwd_dkv_kernel<{d}>: two launches differ: {bit_equal}")
    t = timing[d]
    ms, pair = t["ms"]["flash_bwd_dkv"], t["ms"]["flash_bwd_dkv"] + t["ms"]["flash_bwd_dq"]
    sdpa = t["library_ms"]["flash_bwd_dkv"]
    emit({"phase": "kernels", "case": f"bwd_dkv_d{d}_against_sdpa", "shape": [48, CE_HEADS[d], 336, d], "ms": ms,
          "bound_ms": t["bound_ms"]["flash_bwd_dkv"], "ratio_to_bound": ms / t["bound_ms"]["flash_bwd_dkv"],
          "bound_by": t["bound_by"]["flash_bwd_dkv"], "dkv_plus_dq_ms": pair, "sdpa_bwd_ms": sdpa,
          "pair_ratio_to_sdpa": pair / sdpa, "bit_equal": bit_equal})
    return max(errs.values())


def check_xla_routing(gen) -> None:
    """A shape that the JAX dispatcher sends to xla_attention, an attention
    of Pythia-2.8B's width (32 heads of 80; causal, 20 padded keys):
    dot_product_attention on the card returns masked_attention's result,
    bit for bit, and launches no kernel."""
    q, k, v, _, mask = _qkv(gen, 2, 32, 336, (256, 276), False, 80)
    A.reset_launches()
    got = A.dot_product_attention(q, k, v, key_padding_mask=mask, causal=True)
    want = A.masked_attention(q, k, v, key_padding_mask=mask, causal=True)
    launches = dict(A.LAUNCHES)
    if launches != _kernels(0, 0) or not got.is_cuda or not torch.equal(got, want):
        raise AssertionError(f"xla routing: launches {launches}, equal {torch.equal(got, want)}")
    emit({"phase": "kernels", "case": "xla_routing_head_dim_80", "shape": list(q.shape), "causal": True,
          "route": "masked_attention", "bit_equal": True, "launches": launches})


def _bound(nbytes: float, flops: float, flops_per_s: float = BF16_FLOPS_PER_S):
    """(least ms for this many bytes and operations on the card, which of the two sets it)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / flops_per_s * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


SDPA_BACKENDS = ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION", "MATH")


def sdpa_backend(q, k, v, keep, scale, do) -> str:
    """The first of SDPA_BACKENDS, in that order, whose forward and
    backward take this call; kernel_timing times SDPA on it at float32."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    for name in SDPA_BACKENDS:
        try:
            with sdpa_kernel(getattr(SDPBackend, name)):
                qg, kg, vg = (x.detach().requires_grad_(True) for x in (q, k, v))
                out = torch.nn.functional.scaled_dot_product_attention(qg, kg, vg, attn_mask=keep, scale=scale)
                torch.autograd.grad(out, (qg, kg, vg), do)
            return name
        except RuntimeError:
            continue
    raise AssertionError("no SDPA backend takes the call")


def kernel_timing(gen, case, b, h, t, d, pad=(256, 276), dtype=torch.bfloat16) -> dict:
    """The three kernels' times at one causal shape with the keys `pad`
    masks (by default 256..275, 20 padded keys) beside the plain versions',
    SDPA's (a yardstick, never called by the port: its forward against the
    forward kernel, its whole backward, which computes dq, dk and dv,
    against each backward kernel; at float32 on the backend sdpa_backend
    names, TF32 off) and each kernel's bound (at float32: 4 bytes an
    element, and the products three times over at the tensor cores' TF32
    rate, as 3xTF32 forms them, the card's least time for float32-accurate
    products; beside it `bound_ffma_ms`, the products at the CUDA cores'
    float32 rate); emitted, and returned with the bounds' causes."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    scale = d ** -0.5
    q, k, v, do, mask = _qkv(gen, b, h, t, pad, False, d, dtype)
    o, lse = A.flash_forward(q, k, v, mask, True, scale)
    delta = (do.float() * o.float()).sum(-1)
    ms = {
        "flash_fwd": time_ms(lambda: A.flash_forward(q, k, v, mask, True, scale)),
        "flash_bwd_dkv": time_ms(lambda: A.flash_bwd_dkv(q, k, v, mask, do, lse, delta, True, scale)),
        "flash_bwd_dq": time_ms(lambda: A.flash_bwd_dq(q, k, v, mask, do, lse, delta, True, scale)),
    }
    plain_fwd = time_ms(lambda: A.flash_forward_plain(q, k, v, mask, True, scale))
    plain_bwd = time_ms(lambda: A.flash_backward_plain(q, k, v, mask, o, lse, do, True, scale))
    plain_ms = {"flash_fwd": plain_fwd, "flash_bwd_dkv": plain_bwd, "flash_bwd_dq": plain_bwd}

    keep = torch.ones(t, t, dtype=torch.bool, device="cuda").tril()[None, None] & (mask > 0)[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    f32 = dtype == torch.float32
    backend = sdpa_backend(q, k, v, keep, scale, do) if f32 else None
    with sdpa_kernel(getattr(SDPBackend, backend)) if f32 else contextlib.nullcontext():
        sdpa_fwd = time_ms(lambda: sdpa(q, k, v, attn_mask=keep, scale=scale))
        qg, kg, vg = (x.detach().requires_grad_(True) for x in (q, k, v))
        out = sdpa(qg, kg, vg, attn_mask=keep, scale=scale)
        sdpa_bwd = time_ms(lambda: torch.autograd.grad(out, (qg, kg, vg), do, retain_graph=True))
    library = {"flash_fwd": sdpa_fwd, "flash_bwd_dkv": sdpa_bwd, "flash_bwd_dq": sdpa_bwd}

    # least time for the same work: each input read once, each output written
    # once; products counted over the (query, key) pairs this mask keeps
    pairs = h * int((torch.ones(t, t, device="cuda").tril()[None] * (mask > 0)[:, None, :]).sum().item())
    act, row, msk = b * h * t * d * q.element_size(), b * h * t * 4, b * t * 4
    work = {  # (bytes, operations)
        "flash_fwd": (3 * act + msk + act + row, 4 * d * pairs),
        "flash_bwd_dkv": (4 * act + 2 * row + msk + 2 * act, 8 * d * pairs),
        "flash_bwd_dq": (4 * act + 2 * row + msk + act, 6 * d * pairs),
    }
    # f32: three TF32 products per float32-accurate one
    bounds = {n: _bound(nb, 3 * ops, TF32_FLOPS_PER_S) if f32 else _bound(nb, ops) for n, (nb, ops) in work.items()}
    res = {"ms": ms, "plain_ms": plain_ms, "library_ms": library, "library_backend": backend,
           "bound_ms": {n: v[0] for n, v in bounds.items()}, "bound_by": {n: v[1] for n, v in bounds.items()}}
    if f32:
        res["bound_ffma_ms"] = {n: _bound(nb, ops, FP32_FLOPS_PER_S)[0] for n, (nb, ops) in work.items()}
    emit({"phase": "kernels", "case": case, "dtype": str(dtype).split(".")[1], "shape": [b, h, t, d], "ms": ms,
          "plain_ms": plain_ms, "sdpa_fwd_ms": sdpa_fwd, "sdpa_bwd_ms": sdpa_bwd, "sdpa_backend": backend,
          "bound_ms": res["bound_ms"], "bound_by": res["bound_by"],
          **({"bound_ffma_ms": res["bound_ffma_ms"]} if f32 else {}), "kept_pairs": pairs})
    return res


def _fwd_timing(gen, b, h, t, d, causal, pad) -> dict:
    """The forward kernel at one shape of the decode or the training paths:
    its time beside the plain version's, SDPA's forward and its bound (as at
    the CE shape)."""
    scale = d ** -0.5
    q, k, v, _, mask = _qkv(gen, b, h, t, pad, False, d)
    keep = torch.ones(t, t, dtype=torch.bool, device="cuda")
    if causal:
        keep = keep.tril()
    keep = keep[None, None] & ((mask > 0)[:, None, None, :] if mask is not None else True)
    pairs = h * int(keep.expand(b, 1, t, t).sum().item())
    act, row = b * h * t * d * 2, b * h * t * 4
    bound_ms, bound_by = _bound(4 * act + row + (b * t * 4 if mask is not None else 0), 4 * d * pairs)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return {"shape": [b, h, t, d], "causal": causal,
            "ms": time_ms(lambda: A.flash_forward(q, k, v, mask, causal, scale)),
            "plain_ms": time_ms(lambda: A.flash_forward_plain(q, k, v, mask, causal, scale)),
            "sdpa_fwd_ms": time_ms(lambda: sdpa(q, k, v, attn_mask=keep, scale=scale)),
            "bound_ms": bound_ms, "bound_by": bound_by, "kept_pairs": pairs}


def example_batch(gen, cfg, b: int, text_len: int, device="cpu", pixels: bool = False):
    """Left-padded text (a quarter of the positions), an 8-token answer suffix,
    cached patch features of the real shape [b, 256, 1024], or with `pixels`
    uint8 NHWC images [b, 224, 224, 3]."""
    input_ids = torch.randint(1, min(200, cfg.vocab_size - 1), (b, text_len), generator=gen, device=device)
    attention_mask = torch.ones(b, text_len, dtype=torch.int32, device=device)
    attention_mask[:, : text_len // 4] = 0
    labels = input_ids.clone()
    labels[:, :-8] = -100
    out = {"input_ids": input_ids, "attention_mask": attention_mask, "labels": labels}
    if pixels:
        side = cfg.vision.img_size
        out["pixels"] = torch.randint(0, 256, (b, side, side, 3), generator=gen, device=device, dtype=torch.uint8)
    else:
        patches = torch.randn(b, cfg.vision.num_patches, cfg.vision.embed_dim, generator=gen, device=device)
        out["patches"] = patches.to(torch.bfloat16)
    return out


def train_config(compute_dtype: str = "bfloat16") -> TrainConfig:
    """The bench's training settings: AdamW with a bf16 first moment, balanced
    modality weights, discounted layers (gamma 0.5); bf16 compute unless
    `compute_dtype` says otherwise."""
    return TrainConfig(
        optim="adamw", weight_decay=0.01, adam_mu_dtype="bfloat16",
        replay_coeff=1.0, distillation_coeff=1.0,
        distillation_modality_weighing_strategy="balanced",
        distillation_layer_weighing_strategy="discounted", distillation_layer_discount=0.5,
        compute_dtype=compute_dtype,
    )


def stack(batches):
    """[n_mb, B, ...] stacks of a list of microbatches."""
    return {k: torch.stack([mb[k] for mb in batches]) for k in batches[0]}


def window_setup(cfg, model, n_ce, b, text_len, gen, device, fuse_ce_batch=True, compute_dtype="bfloat16"):
    train_cfg = train_config(compute_dtype)
    teacher = make_teacher(model)
    trainable = trainable_parameters(model)
    opt = build_optimizer(train_cfg, trainable, tp=model.tp)
    state = TrainState(0, model, set_schedule(opt.init(trainable), 0, 100))
    step = make_mafed_window_step(cfg, train_cfg, opt, n_ce=n_ce, fuse_ce_batch=fuse_ce_batch, device=device)
    mbs = [example_batch(gen, cfg, b, text_len) for _ in range(n_ce + 1)]  # on the CPU: same data on any device
    ce = {k: torch.stack([mb[k] for mb in mbs[:n_ce]]).to(device) for k in mbs[0]}
    distill = {k: v.to(device) for k, v in mbs[n_ce].items()}
    lang = torch.full((cfg.num_hidden_layers - 1,), 0.5, device=device)
    return step, state, teacher, ce, distill, lang


def _rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return ((got.float().cpu() - want.float()).norm() / want.float().norm()).item()


def tower_and_prefill(model, cfg, pixels, input_ids, attention_mask, device):
    """(tower features, last-position logits of the KV-cache prefill), bf16."""
    dtype = torch.bfloat16
    with torch.inference_mode():
        px = prep_pixels({"pixels": pixels.to(device)}, make_normalizer(cfg.vision), dtype)
        feats = model.vision_encoder.forward_features(px, dtype=dtype)
        ids, mask = input_ids.to(device), attention_mask.to(device)
        embeds, full_mask = V.build_inputs(model, ids, mask, pixel_values=px, dtype=dtype)
        cache = gpt_neox.KVCache.create(cfg, ids.shape[0], embeds.shape[1] + 1, dtype=dtype, device=device)
        buf_mask = torch.cat([full_mask, full_mask.new_ones((ids.shape[0], 1))], dim=1)
        hidden = model.gpt_neox(embeds, attention_mask=buf_mask, cache=cache, dtype=dtype)["last_hidden_state"]
        return feats, gpt_neox.logits(model.embed_out, hidden[:, -1], dtype=dtype)


# tiny decoders: 2 heads of 64; of 96 as GPT-NeoX-20B's; of 128 as Pythia-1.4B's; of 256 as VL-Pythia-1B's;
# of 384 and 512 as the regrouped decoders' (the wide kernels)
TINY_DECODERS = {64: dict(hidden_size=128, num_hidden_layers=3, intermediate_size=256),
                 96: dict(hidden_size=192, num_hidden_layers=2, intermediate_size=384),
                 128: dict(hidden_size=256, num_hidden_layers=2, intermediate_size=512),
                 256: dict(hidden_size=512, num_hidden_layers=2, intermediate_size=1024),
                 384: dict(hidden_size=768, num_hidden_layers=2, intermediate_size=1536),
                 512: dict(hidden_size=1024, num_hidden_layers=2, intermediate_size=2048)}


def tiny_config(head_dim: int = 64) -> ModelConfig:
    """A tiny VL-Pythia whose decoder has 2 heads of `head_dim` and whose tower
    has heads of 64 (16 patches + CLS), so every attention call takes the
    flash kernels."""
    return ModelConfig(vocab_size=512, num_attention_heads=2, **TINY_DECODERS[head_dim],
                       vision=VisionConfig(img_size=56, embed_dim=128, depth=2, num_heads=2))


def phase_reference(head_dim: int) -> None:
    """One window of a tiny model (decoder heads of `head_dim`) on the card
    against the same window on the CPU, both bf16: losses within rtol 3e-2
    (bf16 matmul outputs and the tiled softmax round differently on the two
    devices). The same model with a head_dim-64 tower (16 patches + CLS): its
    tower features and the KV-cache prefill's last-position logits on the
    card against the CPU, relative norm error within 3e-2."""
    cfg = tiny_config(head_dim)
    gen = torch.Generator().manual_seed(3)
    pixels = torch.randint(0, 256, (4, 56, 56, 3), generator=gen, dtype=torch.uint8)
    input_ids = torch.randint(1, 500, (4, 24), generator=gen)
    attention_mask = torch.ones(4, 24, dtype=torch.int32)
    attention_mask[:, :5] = 0
    metrics, evals = {}, {}
    for device in ("cpu", "cuda"):
        model = init_model(cfg, seed=0, device="cpu").to(device)
        evals[device] = tower_and_prefill(model, cfg, pixels, input_ids, attention_mask, device)
        step, state, teacher, ce, distill, lang = window_setup(
            cfg, model, 3, 4, 24, torch.Generator().manual_seed(1), device)
        _, m = step(state, teacher, ce, distill, lang)
        metrics[device] = {k: float(m[k]) for k in ("loss", "ce_loss", "distill_loss", "grad_norm")}
    for key, want in metrics["cpu"].items():
        got = metrics["cuda"][key]
        if not abs(got - want) <= 3e-2 * abs(want):
            raise AssertionError(f"reference window: {key} {got} on the card vs {want} on the CPU")
    errs = {name: _rel_err(got, want) for name, got, want in zip(("tower", "prefill_logits"), evals["cuda"], evals["cpu"])}
    if not all(e <= 3e-2 for e in errs.values()):
        raise AssertionError(f"reference eval: relative errors {errs} on the card vs the CPU, above 3e-2")
    emit({"phase": "reference", "case": f"window_head_dim_{head_dim}", "cpu": metrics["cpu"], "cuda": metrics["cuda"],
          "rtol": 3e-2, "eval_rel_err": errs})


def reference_steps(cfg, device):
    """bf16 on `device`, from the same seeded tiny model each time: a CE window
    of 4 microbatches, an EWC window (F uniform in [0, 1), theta* = theta +
    N(0, 0.01^2)), one train step, one distill step (a teacher of other
    weights), the Fisher importances over two batches and the adaptive-weight
    sums of the memory batch. Returns (losses and grad norms by path,
    {"fisher", "adaptive_sums"} flattened on the CPU)."""
    gen = torch.Generator().manual_seed(6)
    mbs = [{k: v.to(device) for k, v in example_batch(gen, cfg, 4, 24).items()} for _ in range(4)]
    train_cfg = train_config()
    lang = torch.full((cfg.num_hidden_layers - 1,), 0.5, device=device)

    def fresh():
        model = init_model(cfg, seed=0, device="cpu").to(device)
        trainable = trainable_parameters(model)
        opt = build_optimizer(train_cfg, trainable)
        return model, trainable, opt, TrainState(0, model, set_schedule(opt.init(trainable), 0, 100))

    def scalars(m):
        return {k: float(m[k]) for k in ("loss", "grad_norm")}

    out = {}
    _, _, opt, state = fresh()
    out["ce_window"] = scalars(make_ce_window_step(cfg, train_cfg, opt, device=device)(state, stack(mbs))[1])
    _, trainable, opt, state = fresh()
    g = torch.Generator().manual_seed(7)
    fisher = {k: torch.rand(p.shape, generator=g).to(device) for k, p in trainable.items()}
    old = {k: (p.detach().cpu() + 0.01 * torch.randn(p.shape, generator=g)).to(device) for k, p in trainable.items()}
    ewc_step = make_ce_window_step(cfg, train_cfg, opt, with_ewc=True, device=device)
    out["ewc_window"] = scalars(ewc_step(state, stack(mbs), (fisher, old))[1])
    _, _, opt, state = fresh()
    out["train_step"] = scalars(make_train_step(cfg, train_cfg, opt, device=device)(state, mbs[0])[1])
    _, _, opt, state = fresh()
    teacher = make_teacher(init_model(cfg, seed=1, device="cpu").to(device))
    out["distill_step"] = scalars(make_distill_step(cfg, train_cfg, opt, device=device)(state, teacher, mbs[3], lang)[1])
    model, trainable, _, _ = fresh()
    importances = {k: torch.zeros_like(p) for k, p in trainable.items()}
    fisher_fn = make_ewc_fisher_fn(cfg, train_cfg, device=device)
    for mb in mbs[:2]:
        fisher_fn(model, mb, importances)
    layers = distillation_layers("discounted", cfg.num_hidden_layers - 1, None)
    sums = make_adaptive_weights_fn(cfg, train_cfg, layers, device=device)(model, mbs[3])
    vectors = {"fisher": torch.cat([v.flatten().cpu() for v in importances.values()]),
               "adaptive_sums": torch.cat([sums[0].cpu(), sums[1].cpu()])}
    return out, vectors


# card against CPU, bf16: losses and grad norms (as the window's), and the
# relative norm error of the Fisher importances (squared bf16 gradients, whose
# relative error doubles) and of the adaptive sums (norms of bf16 gradients)
STEP_RTOL, VECTOR_RTOL = 3e-2, 5e-2


def phase_reference_steps() -> None:
    cfg = tiny_config()
    (cpu, cpu_vec), (card, card_vec) = (reference_steps(cfg, d) for d in ("cpu", "cuda"))
    for path, want in cpu.items():
        for key, w in want.items():
            if not abs(card[path][key] - w) <= STEP_RTOL * abs(w):
                raise AssertionError(f"reference {path}: {key} {card[path][key]} on the card vs {w} on the CPU")
    errs = {name: _rel_err(card_vec[name], cpu_vec[name]) for name in cpu_vec}
    if not all(e <= VECTOR_RTOL for e in errs.values()):
        raise AssertionError(f"reference Fisher / adaptive sums: relative errors {errs}, above {VECTOR_RTOL}")
    emit({"phase": "reference", "case": "steps", "cpu": cpu, "cuda": card, "rtol": STEP_RTOL,
          "rel_err": errs, "rel_err_limit": VECTOR_RTOL})


def phase_reference_tables() -> None:
    """The device tables gather on the card the rows they gather on the CPU,
    bit for bit: the vision table in bfloat16 and in int8 (its dequantizing
    multiply in bfloat16 on both devices) at the 410M features' shape
    [64, 256, 1024], and the teacher table at the 410M sequence's states
    [8, 23, 336, 1024]; a window's [4, 16] rows and a batch's 16."""
    gen = torch.Generator().manual_seed(9)
    feats = (torch.randn(64, 256, 1024, generator=gen) * torch.rand(64, 256, 1, generator=gen) * 8).to(torch.bfloat16)
    rows = torch.randint(0, 64, (4, 16), generator=gen, dtype=torch.int32).numpy()
    checked = {}
    for dtype in ("bfloat16", "int8"):
        got = {dev: vt.DeviceVisionTable(feats, {f"k{i}": i for i in range(64)}, dtype=dtype, device=dev)
               for dev in ("cpu", "cuda")}
        card, cpu = (got[dev].resolve({"patch_idx": rows})["patches"] for dev in ("cuda", "cpu"))
        if card.device.type != "cuda" or not torch.equal(card.cpu(), cpu):
            raise AssertionError(f"reference tables: the {dtype} vision table's rows on the card != on the CPU")
        checked[f"vision_{dtype}"] = list(card.shape)
    states = torch.randn(8, 23, 336, 1024, generator=gen).to(torch.bfloat16)
    idx = torch.randint(0, 8, (16,), generator=gen, dtype=torch.int32).numpy()
    tables = {dev: ttc.DeviceTeacherTable(states, {f"q{i}": i for i in range(8)}, device=dev) for dev in ("cpu", "cuda")}
    card, cpu = (tables[dev].resolve({"t_idx": idx})["t_hs"] for dev in ("cuda", "cpu"))
    if card.device.type != "cuda" or not torch.equal(card.cpu(), cpu):
        raise AssertionError("reference tables: the teacher table's rows on the card != on the CPU")
    checked["teacher"] = list(card.shape)
    emit({"phase": "reference", "case": "tables", "bit_equal": checked})


# Published GPT-NeoX decoders whose heads the kernels take at 128 and 96, as ModelConfig fields (the
# JAX package has no preset for them and runs them from a config file, ModelConfig.from_json); the
# other fields keep ModelConfig's defaults, which are those configs' own (rotary_pct 0.25, parallel
# residual, rotary base 10000, layer-norm eps 1e-5). No published GPT-NeoX decoder has heads of 384
# or more: the "_d512" and "_d384" entries regroup a published width's heads (the same parameters,
# activations and products; only the attention's head shape changes)
DECODER_CONFIGS = {
    # EleutherAI/pythia-1.4b config.json: 16 heads of 128, full depth
    "1.4b": dict(hidden_size=2048, num_hidden_layers=24, num_attention_heads=16, intermediate_size=8192),
    # EleutherAI/gpt-neox-20b config.json: 64 heads of 96, vocab 50432; cut to 4 of its 44 layers (its
    # weights alone take ~41 GB in bf16 at full depth, and training ~16 bytes a parameter)
    "neox20b_4l": dict(hidden_size=6144, num_hidden_layers=4, num_attention_heads=64, intermediate_size=24576,
                       vocab_size=50432),
    # config/vlpythia-1b.json's decoder (the trainer's default) as 4 heads of 512, full depth
    "1b_d512": dict(hidden_size=2048, num_hidden_layers=16, num_attention_heads=4, intermediate_size=8192),
    # neox20b_4l as 16 heads of 384
    "neox20b_4l_d384": dict(hidden_size=6144, num_hidden_layers=4, num_attention_heads=16, intermediate_size=24576,
                            vocab_size=50432),
}


def model_config(preset: str) -> ModelConfig:
    """VL-Pythia with the EVA-02-L tower and the decoder of `preset`: a
    preset of the package (410m, 1b) or one of DECODER_CONFIGS."""
    if preset in DECODER_CONFIGS:
        return ModelConfig(**DECODER_CONFIGS[preset])
    return model_config_for_preset(preset)


def phase_window(smi: str, preset: str, phase: str, plain_check: bool = False, compute_dtype: str = "bfloat16",
                 reference=None) -> dict:
    """Three fused MAFED windows of VL-Pythia-`preset` at full width and depth
    (bench.py's shape) at `compute_dtype`, every launch of that dtype; with
    `plain_check`, then the kernels against the plain versions on one small
    window (`check_window_against_plain`). At float32 the MFU is against the
    card's float32 peak, and `reference`, the metrics of the bf16 windows
    from the same weights and data, gives the relative differences of the
    metrics; the first window's (before any update) within STEP_RTOL.
    Returns the emitted line (its "launches" by head_dim)."""
    cfg = model_config(preset)
    n_ce, b, text_len, windows = 3, 16, 80, 3
    model = init_model(cfg, seed=0, device="cuda")
    step, state, teacher, ce, distill, lang = window_setup(
        cfg, model, n_ce, b, text_len, torch.Generator().manual_seed(2), "cuda", compute_dtype=compute_dtype)
    before = {n: p.detach().clone() for n, p in trainable_parameters(model).items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    A.reset_launches()
    times, history = [], []
    for _ in range(windows):
        start = time.perf_counter()
        state, m = step(state, teacher, ce, distill, lang)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - start) * 1e3)
        history.append({k: float(m[k]) for k in ("loss", "ce_loss", "distill_loss", "grad_norm")})
    launches, by_dtype = launches_by_dim(), dict(A.LAUNCHES_BY_DTYPE)

    for h in history:
        bad = [k for k, v in h.items() if not torch.isfinite(torch.tensor(v))]
        if bad:
            raise AssertionError(f"non-finite window metrics: {bad} in {h}")
    unchanged = [n for n, p in trainable_parameters(model).items() if torch.equal(p, before[n])]
    if unchanged:
        raise AssertionError(f"parameters that no update moved: {unchanged[:5]} ({len(unchanged)})")
    layers = cfg.num_hidden_layers
    expected = window_launches(cfg, windows)
    if launches != expected or by_dtype != {compute_dtype: expected[cfg.head_dim]}:
        raise AssertionError(f"{phase}: kernel launches {launches}, by dtype {by_dtype}, expected {expected}, "
                             f"all {compute_dtype}")

    ms_window = sum(times[1:]) / (windows - 1)  # the first window pays cuBLAS and allocator warm-up
    examples = (n_ce + 1) * b
    ex_per_s = examples / (ms_window / 1e3)
    flops = framework_window_flops(cfg, text_len, n_ce, b) / examples
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    peak = FP32_FLOPS_PER_S if compute_dtype == "float32" else BF16_FLOPS_PER_S
    line = {"phase": phase, "card": smi, "preset": preset, "compute_dtype": compute_dtype, "layers": layers,
            "hidden": cfg.hidden_size, "heads": cfg.num_attention_heads, "head_dim": cfg.head_dim,
            "intermediate": cfg.intermediate_size, "vocab": cfg.vocab_size, "n_ce": n_ce, "batch": b,
            "text_len": text_len, "window_ms": times, "ms_per_window": ms_window, "examples_per_s": ex_per_s,
            "mfu": mfu(ex_per_s, flops, peak), "mfu_peak_flops": peak, "peak_memory_gb": peak_gb,
            "metrics": history, "launches": launches, "launches_by_dtype": by_dtype, "expected_launches": expected}
    if reference is not None:
        line["rel_diff_vs_bf16"] = [{k: abs(h[k] - r[k]) / abs(r[k]) for k in h} for h, r in zip(history, reference)]
        first = line["rel_diff_vs_bf16"][0]
        if not all(e <= STEP_RTOL for e in first.values()):
            raise AssertionError(f"{phase}: the first window's metrics {history[0]} against the bf16 window's "
                                 f"{reference[0]}: relative differences {first}, above {STEP_RTOL}")
    if plain_check:
        del step, state, teacher, ce, distill
        free_device_memory()
        line["against_plain"] = check_window_against_plain(cfg, model, before, compute_dtype=compute_dtype)
    emit(line)
    return line


# kernels against plain versions through a whole window, bf16 on the card: the attention outputs
# differ by a few bf16 ulps (ATOL, RTOL), which the losses and the weight gradients average over.
# Each limit is about 10x the largest sound reading on the H100 (1.4B and the 20B-width cut): losses
# and global norm 2.3e-4; the attention weights' gradients 1.4e-3 in norm and 4.3e-2 as
# |kernels - plain| / |plain| (the q and k rows, which take dS, at random init). A dQ that is zero,
# negated or zero past column 64 leaves the losses and the global norm at 1.4B within
# PLAIN_WINDOW_RTOL, and fails the attention weights' limits (as a dV zero past column 64 does)
PLAIN_WINDOW_RTOL = 3e-3
PLAIN_ATTN_NORM_RTOL = 1.5e-2
PLAIN_ATTN_DIFF_RTOL = 0.4
# the same at float32 (phase window_f32): the attention outputs differ by float32 rounding only
# (F32_ATOL), so the limits are 30x (window) and 15x / 40x (attention weights) tighter
PLAIN_F32_LIMITS = (1e-4, 1e-3, 1e-2)


def _attention_grad_parts(name: str, grad: torch.Tensor, cfg) -> dict:
    """The gradient of an attention projection's weight, query_key_value's
    split into its q, k and v rows (HF's fused [heads, 3, head_dim] layout),
    so that a wrong dQ, dK or dV shows in a part of its own."""
    if "query_key_value" not in name:
        return {name: grad}
    g = grad.view(-1, 3, cfg.head_dim, grad.shape[1])
    return {f"{name}[{part}]": g[:, i] for i, part in enumerate("qkv")}


def check_window_against_plain(cfg, model, snapshot: dict, b: int = 2, compute_dtype: str = "bfloat16") -> dict:
    """One fused MAFED window of `model` at `b` rows a microbatch (text 80,
    3 CE microbatches and a memory one) from the trainable weights
    `snapshot`, twice: through the kernels, then with FlashAttention's
    forward and backward calling the plain versions on the same card
    tensors. Losses and the global gradient norm within PLAIN_WINDOW_RTOL.
    The gradient of every attention weight (each layer's query_key_value, in
    its q, k and v rows, and dense: what dQ, dK and dV reach first) against
    the plain run's: its norm within PLAIN_ATTN_NORM_RTOL (a scaled or
    partly missing gradient), |kernels - plain| / |plain| within
    PLAIN_ATTN_DIFF_RTOL (a wrong sign or a wrong row, whatever the norm);
    at float32 `compute_dtype` within PLAIN_F32_LIMITS instead. The
    kernels' launches as computed, all of `compute_dtype`, the plain run's
    none."""
    window_rtol, norm_rtol, diff_rtol = (PLAIN_F32_LIMITS if compute_dtype == "float32" else
                                         (PLAIN_WINDOW_RTOL, PLAIN_ATTN_NORM_RTOL, PLAIN_ATTN_DIFF_RTOL))
    runs, launches, grads, attn, by_dtype = {}, {}, {}, {}, {}

    def record(route, name, grad):
        for part, g in _attention_grad_parts(name, grad.float(), cfg).items():
            if route == "kernels":
                grads[part] = g.clone()
            else:
                got = grads.pop(part)
                attn[part] = ((got.norm() - g.norm()).abs().item() / g.norm().item(),
                              (got - g).norm().item() / g.norm().item())

    for route in ("kernels", "plain"):
        with torch.no_grad():
            for name, p in trainable_parameters(model).items():
                p.copy_(snapshot[name])
        step, state, teacher, ce, distill, lang = window_setup(
            cfg, model, 3, b, 80, torch.Generator().manual_seed(8), "cuda", compute_dtype=compute_dtype)
        hooks = [p.register_post_accumulate_grad_hook(lambda p, n=n, r=route: record(r, n, p.grad))
                 for n, p in trainable_parameters(model).items() if ".attention." in n and n.endswith(".weight")]
        A.reset_launches()
        try:
            with plain_attention(route == "plain"):
                _, m = step(state, teacher, ce, distill, lang)
        finally:
            for h in hooks:
                h.remove()
        runs[route] = {k: float(m[k]) for k in ("loss", "ce_loss", "distill_loss", "grad_norm")}
        launches[route], by_dtype[route] = launches_by_dim(), dict(A.LAUNCHES_BY_DTYPE)
        del step, state, teacher, ce, distill
        free_device_memory()
    expected = window_launches(cfg)
    if (launches["kernels"] != expected or launches["plain"] != at_head_dim(cfg.head_dim, _kernels(0, 0))
            or by_dtype["kernels"] != {compute_dtype: expected[cfg.head_dim]}):
        raise AssertionError(f"window against plain: launches {launches}, by dtype {by_dtype}, expected {expected} "
                             f"({compute_dtype}) and none")
    if grads or len(attn) != 4 * cfg.num_hidden_layers:
        raise AssertionError(f"window against plain: attention gradients compared {sorted(attn)}, "
                             f"unmatched {sorted(grads)}; expected 4 parts a layer")
    errs = {k: abs(runs["kernels"][k] - w) / abs(w) for k, w in runs["plain"].items()}
    by_part = {}  # the largest (norm, difference) error over the layers, by weight and part
    for part, e in attn.items():
        key = part.split(".attention.")[1]
        by_part[key] = [max(x, y) for x, y in zip(e, by_part.get(key, (0.0, 0.0)))]
    norm_err, diff_err = (max(e[i] for e in by_part.values()) for i in (0, 1))
    if not all(e <= window_rtol for e in errs.values()) or norm_err > norm_rtol or diff_err > diff_rtol:
        raise AssertionError(f"window against plain: {runs}, relative errors {errs} (limit {window_rtol}); "
                             f"attention weight gradients (norm, difference) by part {by_part} "
                             f"(limits {norm_rtol}, {diff_rtol})")
    return {"batch": b, **runs, "rel_err": errs, "rtol": window_rtol, "attn_grads": len(attn),
            "attn_grad_norm_diff_err": by_part, "attn_rtol": [norm_rtol, diff_rtol]}


@contextlib.contextmanager
def plain_attention(on: bool):
    """With `on`, FlashAttention's forward and backward call the plain
    versions directly (on whatever device the tensors are), and no kernel
    launches; the wrappers come back on exit."""
    saved = A.flash_forward, A.flash_backward
    if on:
        A.flash_forward, A.flash_backward = A.flash_forward_plain, A.flash_backward_plain
    try:
        yield
    finally:
        A.flash_forward, A.flash_backward = saved


def _kernels(fwd: int, bwd: int) -> dict:
    return {"flash_fwd": fwd, "flash_bwd_dkv": bwd, "flash_bwd_dq": bwd}


def window_launches(cfg, windows: int = 1) -> dict:
    """Launches by head_dim of `windows` fused MAFED windows, all at the
    decoder's head_dim: fwd in every layer of the CE (L), student (L) and
    teacher (L - 2, early exit) passes, plus the per-layer recompute of the
    2 L differentiated layers in backward; dK/dV and dQ once per
    differentiated layer (410M: 118 / 48 / 48 a window; 1B: 78 / 32 / 32;
    1.4B: 118 / 48 / 48; the 20B-width cut: 18 / 8 / 8)."""
    layers = cfg.num_hidden_layers
    return at_head_dim(cfg.head_dim, _kernels(windows * (5 * layers - 2), windows * 2 * layers))


def run_path(name, calls, trainable=None, snapshot=None, head_dim=64) -> dict:
    """Run one path's calls in order, each a (fn, launches, examples, flops)
    with fn() -> metrics; check finite metrics, the kernel launches (all at
    `head_dim`) and, when a snapshot is given, that every trainable tensor
    moved. Times exclude the first call (cuBLAS and allocator warm-up)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    A.reset_launches()
    times, history = [], []
    for fn, _, _, _ in calls:
        start = time.perf_counter()
        m = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - start) * 1e3)
        history.append({k: v.float().tolist() for k, v in m.items()})
    launches = launches_by_dim()
    expected = at_head_dim(head_dim, {k: sum(c[1][k] for c in calls) for k in A.LAUNCHES})
    if launches != expected:
        raise AssertionError(f"{name}: kernel launches {launches}, expected {expected}")
    bad = [h for h in history if not all(np.isfinite(v).all() for v in h.values())]
    if bad:
        raise AssertionError(f"{name}: non-finite metrics {bad[0]}")
    if snapshot is not None:
        unchanged = [n for n, p in trainable.items() if torch.equal(p, snapshot[n])]
        if unchanged:
            raise AssertionError(f"{name}: parameters that no update moved: {unchanged[:5]} ({len(unchanged)})")
    ms = sum(times[1:])
    examples, flops = sum(c[2] for c in calls[1:]), sum(c[3] for c in calls[1:])
    return {"calls": len(calls), "call_ms": times, "ms_per_call": ms / (len(calls) - 1),
            "examples_per_s": examples / (ms / 1e3), "mfu": mfu(examples / (ms / 1e3), flops / examples),
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9, "launches": launches[head_dim],
            "launches_by_head_dim": launches, "metrics": history}


def _call(box, step, *args):
    """fn() that runs step(box[0], *args), keeps the new state in box[0] and returns the metrics."""
    def fn():
        box[0], m = step(box[0], *args)
        return m
    return fn


def phase_train_steps(smi: str):
    """The other training paths of VL-Pythia-410M, each from the same seeded
    weights, on the same 4 microbatches of 16 (cached features = the port's
    tower on their pixels)."""
    cfg = model_config_for_preset("410m")
    n_mb, b, text_len = 4, 16, 80
    n_ce = n_mb - 1
    layers, vis_depth = cfg.num_hidden_layers, cfg.vision.depth
    model = init_model(cfg, seed=0, device="cuda")
    train_cfg = train_config()
    trainable = trainable_parameters(model)
    snapshot = {k: p.detach().clone() for k, p in trainable.items()}
    teacher = make_teacher(init_model(cfg, seed=1, device="cuda"))  # the previous task's model
    distilled = distillation_layers(train_cfg.distillation_layer_weighing_strategy, layers - 1,
                                    train_cfg.distillation_layer)
    deepest = max(distilled)  # the teacher's early exit
    lang = torch.full((len(distilled),), 0.5, device="cuda")
    gen = torch.Generator().manual_seed(5)
    px = [{k: v.cuda() for k, v in example_batch(gen, cfg, b, text_len, pixels=True).items()} for _ in range(n_mb)]
    normalize = make_normalizer(cfg.vision)
    with torch.no_grad():
        mbs = [{**{k: v for k, v in m.items() if k != "pixels"},
                "patches": V.get_patch_embeddings(model, prep_pixels(m, normalize, torch.bfloat16))} for m in px]

    def fresh(every_k=None):
        """The snapshot's weights and a new optimizer state: (optimizer, state box)."""
        with torch.no_grad():
            for k, p in trainable.items():
                p.copy_(snapshot[k])
        opt = build_optimizer(train_cfg, trainable)
        if every_k:
            opt = MultiSteps(opt, every_k)
        return opt, [TrainState(0, model, set_schedule(opt.init(trainable), 0, 100))]

    ce_ex = ce_example_flops(cfg, text_len)
    memory_ex = framework_window_flops(cfg, text_len, 0, 1)  # one memory example: student + teacher
    train_call = _kernels(layers, layers)  # no remat: the saved (o, lse) go to the backward kernels
    remat_pass = _kernels(2 * layers, layers)  # a forward, and the layers' recompute in backward
    paths, first = {}, {}

    opt, box = fresh()
    step = make_ce_window_step(cfg, train_cfg, opt)
    paths["ce_window"] = run_path("ce_window", [(_call(box, step, stack(mbs)), remat_pass, n_mb * b, n_mb * b * ce_ex)] * 3,
                                  trainable, snapshot)

    fresh()
    importances = {k: torch.zeros_like(p) for k, p in trainable.items()}
    fisher_fn = make_ewc_fisher_fn(cfg, train_cfg)

    def fisher_call(mb):
        def fn():
            fisher_fn(model, mb, importances)
            return {}
        return fn

    paths["ewc_fisher"] = run_path("ewc_fisher", [(fisher_call(mb), train_call, b, b * ce_ex) for mb in mbs[:2]])
    ewc_state = ({k: v / (2 * b) for k, v in importances.items()}, snapshot)  # F over the samples; theta* = the start
    del importances
    opt, box = fresh()
    step = make_ce_window_step(cfg, train_cfg, opt, with_ewc=True)
    paths["ewc_window"] = run_path(
        "ewc_window", [(_call(box, step, stack(mbs), ewc_state), remat_pass, n_mb * b, n_mb * b * ce_ex)] * 3,
        trainable, snapshot)
    del ewc_state

    opt, box = fresh(every_k=n_mb)
    step = make_train_step(cfg, train_cfg, opt)
    paths["train_step_cadence"] = run_path(
        "train_step_cadence", [(_call(box, step, mb), train_call, b, b * ce_ex) for mb in mbs], trainable, snapshot)

    opt, box = fresh(every_k=n_mb)
    step, d_step = make_train_step(cfg, train_cfg, opt), make_distill_step(cfg, train_cfg, opt)
    calls = [(_call(box, step, mb), train_call, b, b * ce_ex) for mb in mbs[:n_ce]]
    calls.append((_call(box, d_step, teacher, mbs[n_ce], lang), _kernels(layers + deepest, layers), b, b * memory_ex))
    paths["mafed_cadence"] = run_path("mafed_cadence", calls, trainable, snapshot)

    fused_window = _kernels(2 * 2 * layers + deepest, 2 * layers)  # CE and student remat, teacher forward only
    window_ex = framework_window_flops(cfg, text_len, n_ce, b)
    ce_stack, memory = stack(mbs[:n_ce]), mbs[n_ce]
    opt, box = fresh()
    step = make_mafed_window_step(cfg, train_cfg, opt, n_ce=n_ce)
    paths["mafed_fused"] = run_path(
        "mafed_fused", [(_call(box, step, teacher, ce_stack, memory, lang), fused_window, n_mb * b, window_ex)] * 2,
        trainable, snapshot)
    opt, box = fresh()
    step = make_mafed_window_step(cfg, train_cfg, opt, n_ce=n_ce, fuse_ce_batch=False)
    unfused = _kernels(n_ce * 2 * layers + 2 * layers + deepest, (n_ce + 1) * layers)
    paths["mafed_unfused"] = run_path(
        "mafed_unfused", [(_call(box, step, teacher, ce_stack, memory, lang), unfused, n_mb * b, window_ex)] * 2,
        trainable, snapshot)
    opt, box = fresh()
    step = make_mafed_window_step(cfg, train_cfg, opt, n_ce=n_ce)
    pixels_window = dict(fused_window, flash_fwd=fused_window["flash_fwd"] + vis_depth)  # the tower once
    pixels_ex = framework_window_flops(cfg, text_len, n_ce, b, vision_cached=False)
    paths["mafed_pixels"] = run_path(
        "mafed_pixels", [(_call(box, step, teacher, stack(px[:n_ce]), px[n_ce], lang), pixels_window, n_mb * b,
                          pixels_ex)] * 2, trainable, snapshot)

    fresh()
    sums_fn = make_adaptive_weights_fn(cfg, train_cfg, distilled)

    def adaptive():
        lang_sums, image_sums, n_lang, n_img = sums_fn(model, memory)
        return {"lang_sums": lang_sums, "image_sums": image_sums, "n_lang": n_lang, "n_img": n_img}

    # a forward and the activation gradients (no weight gradients): ~2/3 of a CE example
    paths["adaptive_weights"] = run_path("adaptive_weights", [(adaptive, train_call, b, b * ce_ex * 2 / 3)] * 2)
    sums = paths["adaptive_weights"]["metrics"][0]
    if min(sums["lang_sums"] + sums["image_sums"]) <= 0:
        raise AssertionError(f"adaptive weights: a non-positive gradient-norm sum in {sums}")

    # cross-path checks from equal starting weights (bf16)
    first = {p: paths[p]["metrics"][0]["loss"] for p in ("ce_window", "mafed_fused", "mafed_unfused", "mafed_pixels")}
    cadence = float(np.mean([m["loss"] for m in paths["train_step_cadence"]["metrics"]]))
    checks = {"cadence_mean_vs_ce_window": (cadence, first["ce_window"]),
              "unfused_vs_fused": (first["mafed_unfused"], first["mafed_fused"]),
              "pixels_vs_cached": (first["mafed_pixels"], first["mafed_fused"])}
    for name, (got, want) in checks.items():
        if not abs(got - want) <= 2e-2 * abs(want):
            raise AssertionError(f"train_steps {name}: {got} vs {want}, beyond rtol 2e-2")
    for p in paths.values():
        del p["metrics"][2:]  # keep the line short: the first two calls' metrics
    emit({"phase": "train_steps", "card": smi, "preset": "410m", "layers": layers, "hidden": cfg.hidden_size,
          "n_mb": n_mb, "batch": b, "text_len": text_len, "paths": paths,
          "cross_checks": {k: {"got": g, "want": w, "rtol": 2e-2} for k, (g, w) in checks.items()}})
    return {p: v["launches_by_head_dim"] for p, v in paths.items()}


def phase_ce_window(smi: str, preset: str, phase: str):
    """Three CE windows (4 microbatches of 16 merged, per-layer remat, one
    AdamW update each) of VL-Pythia-`preset` at full width and depth: 2 L
    forward and L of each backward launch a window, all at the decoder's
    head_dim (1B: 256; 1.4B: 128)."""
    cfg = model_config(preset)
    n_mb, b, text_len = 4, 16, 80
    layers = cfg.num_hidden_layers
    model = init_model(cfg, seed=0, device="cuda")
    train_cfg = train_config()
    trainable = trainable_parameters(model)
    snapshot = {k: p.detach().clone() for k, p in trainable.items()}
    opt = build_optimizer(train_cfg, trainable)
    box = [TrainState(0, model, set_schedule(opt.init(trainable), 0, 100))]
    gen = torch.Generator().manual_seed(5)
    mbs = stack([{k: v.cuda() for k, v in example_batch(gen, cfg, b, text_len).items()} for _ in range(n_mb)])
    step = make_ce_window_step(cfg, train_cfg, opt)
    path = run_path(phase, [(_call(box, step, mbs), _kernels(2 * layers, layers), n_mb * b,
                             n_mb * b * ce_example_flops(cfg, text_len))] * 3,
                    trainable, snapshot, head_dim=cfg.head_dim)
    emit({"phase": phase, "card": smi, "preset": preset, "layers": layers, "hidden": cfg.hidden_size,
          "head_dim": cfg.head_dim, "n_mb": n_mb, "batch": b, "text_len": text_len, **path})
    return path["launches_by_head_dim"]


def decode_batches(cfg, n: int, b: int, text_len: int, pad: int, seed: int):
    """Host (numpy) batches as a loader gives them: left-padded text and
    uint8 NHWC pixels."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        mask = np.ones((b, text_len), np.int32)
        mask[:, :pad] = 0
        out.append({
            "input_ids": rng.integers(1, 257, size=(b, text_len)).astype(np.int32),
            "attention_mask": mask,
            "pixels": np.stack([synthetic_image(seed * 1000 + i * b + j, cfg.vision) for j in range(b)]),
        })
    return out


def run_decode(decode, model, batches):
    """Decode every batch, dispatching batch i+1 before reading batch i: (tokens, ms per batch)."""
    torch.cuda.synchronize()
    start, pending, toks = time.perf_counter(), None, []
    for batch in batches:
        out = decode(model, batch)
        if pending is not None:
            toks.append(pending.cpu())
        pending = out
    toks.append(pending.cpu())
    return toks, (time.perf_counter() - start) * 1e3 / len(batches)


def check_cache_invariance(model, cfg, batch, toks, eos: int) -> dict:
    """A no-cache forward over prefix + emitted tokens: each emitted token up
    to a row's first EOS must be within bf16 tolerance (2e-2 |max|) of the
    argmax logit at its position."""
    dtype, max_new = torch.bfloat16, toks.shape[1]
    ids = torch.cat([torch.from_numpy(batch["input_ids"]), toks[:, :-1]], dim=1).cuda()
    mask = torch.from_numpy(batch["attention_mask"]).cuda()
    mask = torch.cat([mask, mask.new_ones((mask.shape[0], max_new - 1))], dim=1)
    with torch.inference_mode():
        px = prep_pixels({"pixels": torch.from_numpy(batch["pixels"]).cuda()}, make_normalizer(cfg.vision), dtype)
        embeds, full_mask = V.build_inputs(model, ids, mask, pixel_values=px, dtype=dtype)
        hidden = model.gpt_neox(embeds, attention_mask=full_mask, dtype=dtype)["last_hidden_state"]
        logits = gpt_neox.logits(model.embed_out, hidden[:, -max_new:], dtype=dtype).float().cpu()
    checked, worst = 0, 0.0
    for r in range(toks.shape[0]):
        for k in range(max_new):
            row = logits[r, k]
            gap = (row.max() - row[toks[r, k]]).item()
            worst = max(worst, gap / row.abs().max().item())
            if gap > 2e-2 * row.abs().max().item():
                raise AssertionError(f"decode row {r} step {k}: token {int(toks[r, k])} is {gap} below the argmax")
            checked += 1
            if toks[r, k] == eos:
                break
    return {"tokens_checked": checked, "worst_gap_over_max": worst}


def phase_decode(smi: str, preset: str, phase: str):
    """Greedy decode of VL-Pythia-`preset` + EVA-02-L (bench_eval.py's
    shapes), uncached and cached routes; returns the launches by head_dim."""
    cfg = model_config(preset)
    b, text_len, pad, max_new, n = 32, 64, 16, 10, 6
    model = init_model(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    decode = make_greedy_decoder(cfg, max_new_tokens=max_new, eos_token_id=0)
    batches = decode_batches(cfg, n + 1, b, text_len, pad, seed=4)
    host = [{k: torch.from_numpy(v) for k, v in bt.items()} for bt in batches]
    normalize = make_normalizer(cfg.vision)
    with torch.inference_mode():  # the cached route's features, from the port's tower
        cached = [{"input_ids": h["input_ids"], "attention_mask": h["attention_mask"],
                   "patches": V.get_patch_embeddings(model, prep_pixels({"pixels": h["pixels"].cuda()}, normalize,
                                                                        torch.bfloat16))}
                  for h in host]
    # forward launches a batch: the tower's blocks at its head_dim (pixels
    # route only), the prefill's layers at the decoder's
    prefill = at_head_dim(cfg.head_dim, _kernels(cfg.num_hidden_layers, 0))
    tower = at_head_dim(cfg.vision.head_dim, _kernels(cfg.vision.depth, 0))
    routes, launches, first = {}, {}, {}
    for route, data, with_tower in (("pixels", host, True), ("patches", cached, False)):
        run_decode(decode, model, data[:1])  # warm-up: cuBLAS, the allocator, the kernel library
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        A.reset_launches()
        toks, ms = run_decode(decode, model, data[1:])
        launches[route] = launches_by_dim()
        expected = _sum_launches([prefill] * n + ([tower] * n if with_tower else []))
        if launches[route] != expected:
            raise AssertionError(f"{phase} ({route}): kernel launches {launches[route]}, expected {expected}")
        if any(t.shape != (b, max_new) or t.dtype != torch.int32 or t.min() < 0 or t.max() >= cfg.vocab_size
               for t in toks):
            raise AssertionError(f"{phase} ({route}): tokens of shape {toks[0].shape} {toks[0].dtype} or out of the vocabulary")
        ex_per_s = b / (ms / 1e3)
        flops = framework_decode_flops_per_example(cfg, text_len, max_new, vision_cached=route == "patches")
        routes[route] = {"ms_per_batch": ms, "examples_per_s": ex_per_s, "mfu": mfu(ex_per_s, flops),
                         "flops_per_example": flops, "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
                         "launches": launches[route], "tokens_row0": toks[0][0].tolist()}
        first[route] = toks[0]
    # the same features reach the decoder on both routes, so the same tokens should come out
    routes["patches"]["tokens_equal_pixels_route"] = torch.equal(first["pixels"], first["patches"])
    invariance = check_cache_invariance(model, cfg, batches[1], first["pixels"], eos=0)

    tokenizer = ByteTokenizer()
    loader = decode_batches(cfg, 3, b, text_len, pad, seed=5)
    loader[-1] = {k: v[:20] for k, v in loader[-1].items()}  # a short last batch: padded, then dropped
    for i, batch in enumerate(loader):
        batch["qids"] = [f"q{i}_{j}" for j in range(len(batch["input_ids"]))]
        batch["answers"] = [["yes", "no", "2"]] * len(batch["input_ids"])
    val_log, results = validate_vqa(model, decode, loader, tokenizer, batch_size=b)
    if val_log["valid/n_ex"] != 2 * b + 20 or len(results) != 2 * b + 20 or not 0 <= val_log["valid/acc"] <= 1:
        raise AssertionError(f"validate_vqa: {val_log}, {len(results)} results")
    emit({"phase": phase, "card": smi, "preset": preset, "head_dim": cfg.head_dim,
          "vision": "eva02_large_patch14_224", "batch": b, "text_len": text_len, "left_pad": pad,
          "max_new_tokens": max_new, "timed_batches": n, "dtype": "bfloat16", "routes": routes,
          "cache_invariance": invariance, "validate": val_log})
    return _sum_launches(launches.values())


def write_synthetic_vqa(root: str, tasks, n_train: int, n_val: int) -> None:
    """The synthetic ContVQA layout the trainer reads: {split}_annotations.json
    and contvqa/tiny/{train,valid}_question_ids.json; question i of every task
    and split asks about synthetic image i."""
    questions = [("what color is the ball", "red"), ("how many dogs are there", "two"),
                 ("what is the person doing", "running"), ("is it raining", "yes"),
                 ("what animal is shown", "cat"), ("what room is this", "kitchen")]
    os.makedirs(os.path.join(root, "contvqa", "tiny"), exist_ok=True)
    records, splits = {"train": {}, "val": {}}, {"train": {}, "valid": {}}
    for task in tasks:
        for split, key, n, suffix in (("train", "train", n_train, "tr"), ("val", "valid", n_val, "va")):
            splits[key][task] = []
            for i in range(n):
                q, a = questions[i % len(questions)]
                qid = f"{task}_{suffix}{i}"
                records[split][qid] = {"image_id": i, "id": qid, "question_id": qid, "question": q,
                                       "img_fname": f"synthetic_{i}", "multiple_choice_answer": a,
                                       "answers": [{"answer": a, "answer_confidence": "yes", "answer_id": j}
                                                   for j in range(10)], "answer_type": "other"}
                splits[key][task].append(qid)
    for split in ("train", "val"):
        with open(os.path.join(root, f"{split}_annotations.json"), "w") as f:
            json.dump(records[split], f)
    for key in ("train", "valid"):
        with open(os.path.join(root, "contvqa", "tiny", f"{key}_question_ids.json"), "w") as f:
            json.dump(splits[key], f)


SHIPPED_CONFIG = "config/train-vqa-base-cl-vlpythia.json"
# the settings phase cl_sequence keeps from before the port had the device tables
STREAMING_SWITCHES = ["--device_vision_table_mb", "0", "--teacher_state_cache", "off"]
# task-1 losses of the default sequence (the teacher's states and the features from
# the tables) against cl_sequence's (the in-step teacher, streamed features): bf16 on
# both sides, the states primed in batches other than the windows' memory batches
SEQUENCE_LOSS_RTOL = 1e-2


def cl_sequence_argv(root: str) -> list:
    """The command line of the sequence: the shipped config, cut to two
    small tasks of one epoch, MAFED with balanced modality weights and
    discounted layers (gamma 0.5); every other setting the trainer's default."""
    return ["--config", SHIPPED_CONFIG, "--output_dir", os.path.join(root, "out"), "--data_dir", root,
            "--question_task_ids", os.path.join(root, "contvqa"), "--exp", "tiny",
            "--train_img_dirs", "unused", "--val_img_dirs", "unused", "--tasks", "taskA", "taskB",
            "--epochs", "1", "1", "--batch_size", "16", "--accumulate_grad_batches", "4", "--replay_interval", "4",
            "--cl_memory", "32", "--cl_method", "featdistill",
            "--distillation_modality_weighing_strategy", "balanced",
            "--distillation_layer_weighing_strategy", "discounted", "--distillation_layer_discount", "0.5",
            "--allow_tokenizer_fallback", "--log_every", "1"]


def drive_sequence(argv, device, model_cfg, keep_checkpoints: str = "first", preempt_after=None,
                   write=None) -> dict:
    """parse_with_config over `argv`, then ContinualLearningTrainer.main, with
    the launch counts set to 0 just before and read just after. Keeps host
    copies of the task checkpoints ("first", "all" or "none", by file name) and
    the (task, epoch) of the resume bundle each fit leaves; writes the task
    checkpoints named in `write` (file names; None: all), so that a run
    whose files nothing reads writes none. With `preempt_after`, a
    preemption is requested after that many updates and only Preempted with
    code 143 ends the run."""
    cfg = parse_with_config(build_arg_parser(), argv)
    model_cfg = model_cfg or ModelConfig.from_json(cfg.model_config)
    saved, bundles = {}, []
    save = continual.save_task_checkpoint

    def save_and_keep(state_dict, path):
        if keep_checkpoints == "all" or (keep_checkpoints == "first" and not saved):
            saved[os.path.basename(path)] = {k: v.detach().float().cpu().clone() for k, v in state_dict.items()}
        if write is None or os.path.basename(path) in write:
            save(state_dict, path)

    continual.save_task_checkpoint = save_and_keep
    preempted = None
    try:
        A.reset_launches()
        start = time.perf_counter()
        trainer = continual.ContinualLearningTrainer(cfg, model_cfg=model_cfg, synthetic_images=True, device=device)
        fit = trainer.runner.fit

        def fit_and_read_bundle(*args, **kwargs):
            out = fit(*args, **kwargs)
            fit_state = os.path.join(cfg.output_dir, "resume", "fit_state.json")
            if os.path.exists(fit_state):  # not with --resume_bundle_every 0
                with open(fit_state) as f:
                    meta = json.load(f)
                bundles.append([meta["task_id"], meta["epoch"]])
            return out

        trainer.runner.fit = fit_and_read_bundle
        if preempt_after is not None:
            preempt.request_preemption_after(preempt_after)
        try:
            result = trainer.main()
        except preempt.Preempted as exc:
            if preempt_after is None or exc.code != 143:
                raise
            result, preempted = None, exc
        wall = time.perf_counter() - start
    finally:
        continual.save_task_checkpoint = save
        preempt.clear()
    if preempt_after is not None and preempted is None:
        raise AssertionError(f"no preemption after {preempt_after} updates")
    return {"cfg": cfg, "model_cfg": model_cfg, "trainer": trainer, "result": result, "wall": wall,
            "launches": launches_by_dim(), "launches_by_dtype": dict(A.LAUNCHES_BY_DTYPE), "saved": saved,
            "bundles": bundles,
            "losses": logged_losses(cfg.output_dir) if trainer.is_main else None,  # rank 0 writes them
            "bundle_save_s": trainer.runner.bundle_save_s,
            "train_ex_per_s": [[h["train_ex_per_s"] for h in log["history"]] for log in trainer.fit_logs]}


def logged_losses(out: str) -> dict:
    """{task: [train_loss of each logged update]} of a run's metrics.jsonl."""
    losses = {}
    with open(os.path.join(out, "log", "metrics.jsonl")) as f:
        for rec in map(json.loads, f):
            for k, v in rec.items():
                if k.endswith("/train_loss"):
                    losses.setdefault(k.split("/")[0], []).append(v)
    return losses


def sequence_launches(cfg, model_cfg, ce: int, mafed: int, decode_batches: int, tower_batches: int,
                      teacher_batches: int, in_step_teacher: bool) -> dict:
    """The flash launches by head_dim of a sequence's run: each CE window a
    forward and its recompute per layer and one backward; each MAFED window
    the same for its CE and student passes, plus the in-step teacher's
    forward through the deepest tap (or none, the teacher's states cached);
    a forward per layer for each decode batch and each tower batch; the
    teacher-cache priming a forward through the deepest tap per batch."""
    layers = model_cfg.num_hidden_layers
    deepest = max(distillation_layers(cfg.distillation_layer_weighing_strategy, layers - 1, cfg.distillation_layer))
    fwd = (ce * 2 * layers + mafed * (4 * layers + (deepest if in_step_teacher else 0))
           + decode_batches * layers + teacher_batches * deepest)
    decoder = _kernels(fwd, ce * layers + mafed * 2 * layers)
    tower = _kernels(tower_batches * model_cfg.vision.depth, 0)
    return _sum_launches([{model_cfg.head_dim: decoder}, {model_cfg.vision.head_dim: tower}])


def check_sequence(phase: str, run: dict, n_train: int, n_val: int, device: str, tables: bool) -> dict:
    """The checks every full sequence passes: the accuracy matrix and BWT,
    the run's files, a resume bundle after each task, the windows each task
    ran, the images primed, and the launches computed from the config
    (checked on the card). Returns the computed counts."""
    cfg, model_cfg, trainer, result = run["cfg"], run["model_cfg"], run["trainer"], run["result"]
    acc = np.asarray(result["accuracy_matrix"])
    if acc.shape != (2, 2) or not np.isfinite(acc).all() or not ((acc >= 0) & (acc <= 1)).all():
        raise AssertionError(f"{phase}: accuracy matrix {acc}")
    if abs(result["bwt"] - (acc[0, 1] - acc[0, 0])) > 1e-12:
        raise AssertionError(f"{phase}: bwt {result['bwt']} != A[0,1] - A[0,0] of {acc}")
    out = cfg.output_dir
    files = [os.path.join(out, "log", "results.json"), os.path.join(out, "log", "hps.json")] + [
        os.path.join(out, "ckpt", f"{t}_best.safetensors") for t in cfg.tasks]
    missing = [f for f in files if not os.path.exists(f)]
    if missing:
        raise AssertionError(f"{phase}: missing {missing}")
    if run["bundles"] != [[0, 0], [1, 0]]:
        raise AssertionError(f"{phase}: resume bundles (task, epoch) after each fit {run['bundles']}")
    batches = n_train // cfg.batch_size
    windows = batches // cfg.accumulate_grad_batches
    steps = [{"ce_window": windows * cfg.epochs[0]}, {"mafed_window": windows * cfg.epochs[1]}]
    if [log["steps"] for log in trainer.fit_logs] != steps:
        raise AssertionError(f"{phase}: steps by task {[log['steps'] for log in trainer.fit_logs]}, expected {steps}")
    # synthetic image i is the same image in every task and split: the val
    # sets prime n_val images, task 0's train set the rest, task 1's none
    primed = [n_val, n_train - n_val, 0]
    if trainer.primed != primed:
        raise AssertionError(f"{phase}: images primed {trainer.primed}, expected {primed}")
    tower_batches = sum(math.ceil(n / 32) for n in primed)
    val_batches = math.ceil(n_val / cfg.val_batch_size)
    decode_batches = val_batches * (sum(cfg.epochs) + len(cfg.tasks) ** 2)  # each epoch, each eval round
    teacher_batches = math.ceil(cfg.cl_memory / cfg.batch_size) if tables else 0
    expected = sequence_launches(cfg, model_cfg, steps[0]["ce_window"], steps[1]["mafed_window"], decode_batches,
                                 tower_batches, teacher_batches, in_step_teacher=not tables)
    # the windows run at the compute dtype; eval, the tower and teacher priming at bfloat16
    by_dtype = {}
    for dtype, part in ((cfg.compute_dtype, sequence_launches(cfg, model_cfg, steps[0]["ce_window"],
                                                              steps[1]["mafed_window"], 0, 0, 0, not tables)),
                        ("bfloat16", sequence_launches(cfg, model_cfg, 0, 0, decode_batches, tower_batches,
                                                       teacher_batches, False))):
        into = by_dtype.setdefault(dtype, _kernels(0, 0))
        for counts in part.values():
            for k, n in counts.items():
                into[k] += n
    if device == "cuda" and (run["launches"] != expected or run["launches_by_dtype"] != by_dtype):
        raise AssertionError(f"{phase}: kernel launches {run['launches']}, by dtype {run['launches_by_dtype']}, "
                             f"expected {expected}, by dtype {by_dtype}")
    return {"decode_batches": decode_batches, "tower_batches": tower_batches, "teacher_batches": teacher_batches,
            "val_batches": val_batches, "expected_launches": expected, "expected_launches_by_dtype": by_dtype}


def phase_cl_sequence(smi: str, device: str = "cuda", model_cfg=None, n_train: int = 128, n_val: int = 32,
                      compute_dtype: str = "bfloat16", phase: str = "cl_sequence"):
    """A two-task MAFED sequence through the trainer's entry points with the
    features streamed and the in-step teacher (STREAMING_SWITCHES) at
    `compute_dtype` (`--compute_dtype float32`: phase cl_sequence_f32, its
    launches of each dtype checked apart); returns the run. `model_cfg`
    replaces the shipped config's model and `device` the card, for a
    rehearsal at a tiny size on the CPU (where no kernel launches, so
    launches are not checked)."""
    switches = STREAMING_SWITCHES + ([] if compute_dtype == "bfloat16" else ["--compute_dtype", compute_dtype])
    with tempfile.TemporaryDirectory(prefix="cl_sequence_") as root:
        write_synthetic_vqa(root, ("taskA", "taskB"), n_train, n_val)
        run = drive_sequence(cl_sequence_argv(root) + switches, device, model_cfg)
        cfg, model_cfg, trainer = run["cfg"], run["model_cfg"], run["trainer"]
        if cfg.compute_dtype != compute_dtype:
            raise AssertionError(f"{phase}: the trainer's compute dtype {cfg.compute_dtype}, not {compute_dtype}")
        counts = check_sequence(phase, run, n_train, n_val, device, tables=False)
        if trainer.vision_tables or trainer.runner.vision_table is not None or trainer.strategy.teacher_cache_log:
            raise AssertionError(f"{phase}: a device table engaged with the streaming switches")
        (path0, want), = run["saved"].items()
        start = time.perf_counter()
        got = load_task_checkpoint(os.path.join(cfg.output_dir, "ckpt", path0))
        load_s = time.perf_counter() - start
        if set(got) != set(want) or not all(torch.equal(got[k], want[k]) for k in want):
            raise AssertionError(f"{phase}: the reloaded task-0 checkpoint differs from the one saved")
        # the teacher is the bf16 of task 0's best model, untouched by task 1's training
        teacher = trainer.strategy.teacher.state_dict()
        moved = [k for k, v in teacher.items()
                 if not k.startswith("vision_encoder.") and not torch.equal(v.cpu(), want[k].to(torch.bfloat16))]
        if moved:
            raise AssertionError(f"{phase}: teacher tensors that differ from task 0's best: {moved[:5]}")

    emit({"phase": phase, "card": smi, "config": SHIPPED_CONFIG, "switches": switches,
          "compute_dtype": cfg.compute_dtype,
          "model_config": cfg.model_config, "layers": model_cfg.num_hidden_layers, "hidden": model_cfg.hidden_size,
          "tasks": cfg.tasks, "train_questions": n_train, "val_questions": n_val, "batch": cfg.batch_size,
          "accumulate": cfg.accumulate_grad_batches,
          "text_len": [trainer.runner.train_text_len, trainer.runner.val_text_len],
          "accuracy_matrix": run["result"]["accuracy_matrix"], "bwt": run["result"]["bwt"],
          "seconds": {"sequence": run["wall"], **trainer.timings, "load": load_s,
                      "bundle_save": trainer.runner.bundle_save_s},
          "train_ex_per_s": run["train_ex_per_s"], "images_primed": trainer.primed,
          "steps": [log["steps"] for log in trainer.fit_logs], "bundles": run["bundles"], "losses": run["losses"],
          **counts, "launches": run["launches"], "launches_by_dtype": run["launches_by_dtype"]})
    del run["trainer"]  # its model and optimizer leave the card
    return run


def _max_rel(got: list, want: list) -> float:
    return max(abs(g - w) / max(abs(w), 1e-12) for g, w in zip(got, want))


def phase_cl_sequence_default(smi: str, streaming: dict, root: str, device: str = "cuda", model_cfg=None,
                              n_train: int = 128, n_val: int = 32):
    """The same sequence, the same command line without STREAMING_SWITCHES:
    the shipped config with no switch. Both device tables engage: the
    vision table over every image (tier train+memory+val), and after task
    0 the teacher table over the 32-example memory; the MAFED windows run
    no teacher and priming adds its forwards. Its accuracy matrix equals
    cl_sequence's (`streaming`), its losses within SEQUENCE_LOSS_RTOL.
    Its data and experiment directory are written under `root` (phase
    cka_sweep reads them). Returns the run, its checkpoints kept on the host."""
    write_synthetic_vqa(root, ("taskA", "taskB"), n_train, n_val)
    run = drive_sequence(cl_sequence_argv(root), device, model_cfg, keep_checkpoints="all")
    counts = check_sequence("cl_sequence_default", run, n_train, n_val, device, tables=True)
    cfg, model_cfg, trainer = run["cfg"], run["model_cfg"], run["trainer"]
    row_mb = V.n_vision_tokens(model_cfg) * model_cfg.vision.embed_dim * 2 / (1 << 20)
    want_vt = [{"tier": "train+memory+val", "rows": n_train, "mb": n_train * row_mb}] * 2
    if trainer.vision_tables != want_vt:
        raise AssertionError(f"cl_sequence_default: vision tables {trainer.vision_tables}, expected {want_vt}")
    deepest = max(trainer.strategy.layers)
    table_mb = (cfg.cl_memory * (deepest + 1) * (V.n_vision_tokens(model_cfg) + trainer.runner.train_text_len)
                * model_cfg.hidden_size * 2 / (1 << 20))
    (log,) = trainer.strategy.teacher_cache_log
    if (log["tier"], log["examples"], log["primed"], log["table_mb"]) != ("table", cfg.cl_memory, cfg.cl_memory, table_mb):
        raise AssertionError(f"cl_sequence_default: teacher cache {log}, expected a table of {table_mb} MB")
    if run["result"]["accuracy_matrix"] != streaming["result"]["accuracy_matrix"]:
        raise AssertionError(f"cl_sequence_default: accuracy {run['result']['accuracy_matrix']} against "
                             f"cl_sequence's {streaming['result']['accuracy_matrix']}")
    loss_err = {task: _max_rel(run["losses"][task], streaming["losses"][task]) for task in streaming["losses"]}
    if not all(e <= SEQUENCE_LOSS_RTOL for e in loss_err.values()):
        raise AssertionError(f"cl_sequence_default: losses against cl_sequence's, relative errors {loss_err}")
    emit({"phase": "cl_sequence_default", "card": smi, "config": SHIPPED_CONFIG, "switches": [],
          "vision_tables": trainer.vision_tables, "teacher_cache": log,
          "accuracy_matrix": run["result"]["accuracy_matrix"], "bwt": run["result"]["bwt"],
          "seconds": {"sequence": run["wall"], **trainer.timings, "bundle_save": run["bundle_save_s"]},
          "train_ex_per_s": run["train_ex_per_s"], "cl_sequence_train_ex_per_s": streaming["train_ex_per_s"],
          "losses": run["losses"], "loss_rel_err_vs_cl_sequence": loss_err, "loss_rtol": SEQUENCE_LOSS_RTOL,
          "bundles": run["bundles"], "steps": [log_["steps"] for log_ in trainer.fit_logs], **counts,
          "launches": run["launches"], "cl_sequence_launches": streaming["launches"]})
    del run["trainer"]
    return run


def phase_cl_resume(smi: str, uninterrupted: dict, device: str = "cuda", model_cfg=None, n_train: int = 128,
                    n_val: int = 32):
    """The default sequence preempted after task 1's first window (a
    preemption requested after task 0's windows + 1 updates; only Preempted
    with code 143 ends it), then the same command with
    --resume_from_checkpoint: task 0 loads, task 1 resumes from the
    mid-epoch bundle. Its {task}_best checkpoints and accuracy matrix equal
    cl_sequence_default's (`uninterrupted`) bit for bit. Launches: each half
    as computed; together the uninterrupted run's and the restart's second
    eval round after task 0. Returns the launches of both halves."""
    with tempfile.TemporaryDirectory(prefix="cl_resume_") as root:
        write_synthetic_vqa(root, ("taskA", "taskB"), n_train, n_val)
        argv = cl_sequence_argv(root)
        cfg = uninterrupted["cfg"]
        windows = n_train // cfg.batch_size // cfg.accumulate_grad_batches
        first = drive_sequence(argv, device, model_cfg, keep_checkpoints="all", preempt_after=windows + 1)
        del first["trainer"]
        gc.collect()
        resume_dir = os.path.join(first["cfg"].output_dir, "resume")
        with open(os.path.join(resume_dir, "fit_state.json")) as f:
            meta = json.load(f)
        want_meta = {"task_id": 1, "epoch": 0, "batches_done": cfg.accumulate_grad_batches, "mem_draws": 1}
        if {k: meta[k] for k in want_meta} != want_meta:
            raise AssertionError(f"cl_resume: bundle {meta}, expected {want_meta}")
        second = drive_sequence(argv + ["--resume_from_checkpoint", resume_dir], device, model_cfg,
                                keep_checkpoints="all")
    trainer = second["trainer"]
    if [log["steps"] for log in trainer.fit_logs] != [{"mafed_window": windows - 1}]:
        raise AssertionError(f"cl_resume: the restart's steps {[log['steps'] for log in trainer.fit_logs]}")
    if second["result"]["accuracy_matrix"] != uninterrupted["result"]["accuracy_matrix"]:
        raise AssertionError(f"cl_resume: accuracy {second['result']['accuracy_matrix']} against "
                             f"{uninterrupted['result']['accuracy_matrix']} uninterrupted")
    ckpt_err = {}
    for name, want in uninterrupted["saved"].items():
        got = {**first["saved"], **second["saved"]}[name]
        if set(got) != set(want):
            raise AssertionError(f"cl_resume: {name} has other tensors than the uninterrupted run's")
        ckpt_err[name] = max((got[k] - want[k]).abs().max().item() for k in want)
        if not all(torch.equal(got[k], want[k]) for k in want):
            raise AssertionError(f"cl_resume: {name} differs from the uninterrupted run's by up to {ckpt_err[name]}")
    if [log["primed"] for log in trainer.strategy.teacher_cache_log] != [0]:
        raise AssertionError(f"cl_resume: the restart primed {trainer.strategy.teacher_cache_log}")
    # launches: the first half primes and trains task 0 and one MAFED window;
    # the second trains the rest of task 1; every eval round runs where it ran
    ucfg, umodel = uninterrupted["cfg"], uninterrupted["model_cfg"]
    vb = math.ceil(n_val / ucfg.val_batch_size)
    tower_batches = sum(math.ceil(n / 32) for n in (n_val, n_train - n_val))
    expected = {
        "first": sequence_launches(ucfg, umodel, windows, 1, vb * 3, tower_batches,
                                   math.ceil(ucfg.cl_memory / ucfg.batch_size), in_step_teacher=False),
        "second": sequence_launches(ucfg, umodel, 0, windows - 1, vb * 5, 0, 0, in_step_teacher=False),
    }
    launches = {"first": first["launches"], "second": second["launches"]}
    if device == "cuda" and launches != expected:
        raise AssertionError(f"cl_resume: kernel launches {launches}, expected {expected}")
    emit({"phase": "cl_resume", "card": smi, "preempt_after_updates": windows + 1, "exit_code": 143,
          "bundle": {k: meta[k] for k in ("task_id", "epoch", "batches_done", "global_step", "mem_draws")},
          "seconds": {"preempted_run": first["wall"], "resumed_run": second["wall"],
                      "uninterrupted_run": uninterrupted["wall"],
                      "round_trip_overhead": first["wall"] + second["wall"] - uninterrupted["wall"],
                      "bundle_save": [first["bundle_save_s"], second["bundle_save_s"]]},
          "train_ex_per_s": [first["train_ex_per_s"], second["train_ex_per_s"]],
          "accuracy_matrix": second["result"]["accuracy_matrix"], "checkpoint_max_abs_diff": ckpt_err,
          "launches": launches, "expected_launches": expected})
    return _sum_launches([launches["first"], launches["second"]])


CAPTION_WORDS = ("a", "the", "red", "small", "dog", "cat", "runs", "sits", "on", "green", "grass", "beside",
                 "wooden", "table", "with", "two", "people", "near", "bright", "window", "in", "old", "city")


def write_caption_manifests(root: str, n_train: int, n_eval: int, n_images: int = 64) -> tuple:
    """(train, eval) JSONL manifests over `n_images` PNG photos of three
    sizes written under `root`; captions of 2 to 30 words (so that byte
    tokens run from ~10 past the 100 kept), every 4th record a
    Visual-Genome region with a bbox (the object-centre crop)."""
    from PIL import Image

    rng = np.random.default_rng(11)
    paths = []
    for i in range(n_images):
        w, h = ((320, 240), (240, 320), (256, 256))[i % 3]
        ramp = np.linspace(0, 255, w, dtype=np.float32)[None, :, None] * np.ones((h, 1, 3), np.float32)
        img = (ramp * 0.5 + rng.integers(0, 128, size=(h, w, 3))).astype(np.uint8)
        paths.append(os.path.join(root, "images", f"{i}.png"))
        os.makedirs(os.path.dirname(paths[-1]), exist_ok=True)
        Image.fromarray(img).save(paths[-1])
    manifests = []
    for split, n in (("train", n_train), ("eval", n_eval)):
        manifests.append(os.path.join(root, f"{split}.jsonl"))
        with open(manifests[-1], "w") as f:
            for i in range(n):
                caption = " ".join(rng.choice(CAPTION_WORDS, size=int(rng.integers(2, 31))))
                row = {"image": paths[i % n_images], "caption": caption, "source": "coco", "metadata": {}}
                if i % 4 == 3:
                    x, y = (int(v) for v in rng.integers(0, 200, size=2))
                    row.update(source="visual_genome", metadata={"bbox": [x, y, 40, 30]})
                f.write(json.dumps(row) + "\n")
    return tuple(manifests)


def pretrain_argv(root: str) -> list:
    """The pretrain command line: the defaults of ModelArguments and
    PretrainConfig (VL-Pythia-410M + EVA-02-L from the seed, batch 128, text
    100, lr 2e-5, warmup 0.03, clip 1.0, AdamW (0.9, 0.999), bf16), one epoch
    over 512 captions with a save and an eval every 2 of its 4 updates."""
    train, evaluation = write_caption_manifests(root, 512, 128)
    return ["--manifest", train, "--eval_manifest", evaluation, "--output_dir", os.path.join(root, "out"),
            "--allow_tokenizer_fallback", "--per_device_train_batch_size", "128", "--model_max_length", "100",
            "--num_train_epochs", "1", "--save_steps", "0.5", "--eval_steps", "0.5"]


def drive_pretrain(run_trainer, device: str = "cuda") -> dict:
    """Run `run_trainer(cls)` with `cls` a PretrainTrainer that records
    itself and the host-clock ms of each step (ending in a synchronise), the
    launch counts set to 0 just before and read just after, the peak memory
    reset before."""
    from mafed_tpu_torch.pretrain.trainer import PretrainTrainer

    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    trainers, step_ms = [], []

    class Recorded(PretrainTrainer):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            trainers.append(self)
            inner = self.step_fn

            def timed(state, batch):
                sync()
                start = time.perf_counter()
                out = inner(state, batch)
                sync()
                step_ms.append((time.perf_counter() - start) * 1e3)
                return out

            self.step_fn = timed

    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    A.reset_launches()
    start = time.perf_counter()
    state = run_trainer(Recorded)
    wall = time.perf_counter() - start
    return {"state": state, "trainer": trainers[0], "step_ms": step_ms, "wall": wall, "launches": launches_by_dim(),
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9 if cuda else None}


def pretrain_launches(cfg, steps: int, eval_batches: int) -> dict:
    """Each step: the tower's blocks forward (no graph) and each decoder
    layer forward and backward (no remat); each eval batch: the tower and
    the decoder forward. All at head_dim 64 (410M and EVA-02-L)."""
    per_image_pass = cfg.vision.depth + cfg.num_hidden_layers
    return at_head_dim(64, _kernels(steps * per_image_pass + eval_batches * per_image_pass,
                                    steps * cfg.num_hidden_layers))


def _logged(out: str) -> dict:
    logged = {"train/loss": [], "eval/loss": []}
    with open(os.path.join(out, "metrics.jsonl")) as f:
        for rec in map(json.loads, f):
            for key in logged:
                if key in rec:
                    logged[key].append([rec["_step"], rec[key]])
    return logged


def phase_pretrain(smi: str, root: str, device: str = "cuda", model_dir=None) -> dict:
    """Captioning pretraining through its entry point,
    mafed_tpu_torch.pretrain_vlpythia.train(argv), at full width and depth:
    4 updates of 128 captions, evals and checkpoints at 2 and 4, then
    checkpoint-final. Asserts the launches computed from the config (on the
    card), finite logged losses, each checkpoint's files and the rotation.
    Returns the run. `model_dir` (a model directory as --model_name) and
    `device` rehearse it at a tiny size on the CPU."""
    from mafed_tpu_torch import pretrain_vlpythia as cli

    argv = pretrain_argv(root) + ["--device", device] + (["--model_name", model_dir] if model_dir else [])

    def run_cli(cls):
        saved = cli.PretrainTrainer
        cli.PretrainTrainer = cls
        try:
            return cli.train(argv)
        finally:
            cli.PretrainTrainer = saved

    run = drive_pretrain(run_cli, device)
    trainer, out = run["trainer"], os.path.join(root, "out")
    cfg, args = trainer.model_cfg, trainer.args
    steps, evals = trainer.total_steps, 2
    if (steps, trainer.global_batch, run["state"].step) != (4, 128, 4):
        raise AssertionError(f"pretrain: {steps} updates of {trainer.global_batch}, state at {run['state'].step}")
    expected = pretrain_launches(cfg, steps, evals * (128 // args.per_device_eval_batch_size))
    if device == "cuda" and run["launches"] != expected:
        raise AssertionError(f"pretrain: kernel launches {run['launches']}, expected {expected}")
    logged = _logged(out)
    if [s for s, _ in logged["train/loss"]] != [1, 2, 3, 4] or [s for s, _ in logged["eval/loss"]] != [2, 4] or \
            not all(np.isfinite(v) for key in logged for _, v in logged[key]):
        raise AssertionError(f"pretrain: logged {logged}")
    # rotation (save_total_limit 2): both numbered checkpoints stay; the best is one of them
    names = sorted(d for d in os.listdir(out) if d.startswith("checkpoint-"))
    files = ["model.safetensors", "opt_state.safetensors", "trainer_state.json"]
    if names != ["checkpoint-2", "checkpoint-4", "checkpoint-final"] or \
            not all(os.path.exists(os.path.join(out, n, f)) for n in names for f in files):
        raise AssertionError(f"pretrain: checkpoints {names} or their files")
    best_step = min(logged["eval/loss"], key=lambda sv: sv[1])[0]
    if trainer.best_path != os.path.join(out, f"checkpoint-{best_step}"):
        raise AssertionError(f"pretrain: best {trainer.best_path}, eval losses {logged['eval/loss']}")
    ms = sum(run["step_ms"][1:]) / (len(run["step_ms"]) - 1)  # the first step pays cuBLAS and allocator warm-up
    ex_per_s = trainer.global_batch / (ms / 1e3)
    flops = ce_example_flops(cfg, args.model_max_length, vision_cached=False)
    emit({"phase": "pretrain", "card": smi, "argv": argv[4:], "layers": cfg.num_hidden_layers,
          "hidden": cfg.hidden_size, "vision_depth": cfg.vision.depth, "batch": trainer.global_batch,
          "text_len": args.model_max_length, "updates": steps, "step_ms": run["step_ms"], "ms_per_step": ms,
          "examples_per_s": ex_per_s, "mfu": mfu(ex_per_s, flops), "flops_per_example": flops,
          "end_to_end_examples_per_s": steps * trainer.global_batch / run["wall"], "seconds": run["wall"],
          "peak_memory_gb": run["peak_memory_gb"], "checkpoint_s": trainer.checkpoint_seconds,
          "checkpoint_gb": {n: sum(os.path.getsize(os.path.join(out, n, f)) for f in files) / 1e9 for n in names},
          "logged": logged, "best": os.path.basename(trainer.best_path), "checkpoints": names,
          "launches": run["launches"], "expected_launches": expected,
          "disk_free_gb": shutil.disk_usage(root).free / 1e9})
    return {"argv": argv, "out": out, "trainer": trainer, "launches": run["launches"], "device": device}


def phase_pretrain_resume(smi: str, uninterrupted: dict) -> dict:
    """A fresh PretrainTrainer on the same command line's settings, resumed
    from the uninterrupted run's checkpoint-2 (mid-epoch: updates 3 and 4 and
    the eval at 4 remain): its checkpoint-final/model.safetensors equal to
    the uninterrupted run's bit for bit, its launches as computed."""
    from mafed_tpu_torch.pretrain_vlpythia import parse_args
    from mafed_tpu_torch.pretrain.dataset import PretrainDataset

    first = uninterrupted["trainer"]
    out = uninterrupted["out"] + "_resumed"
    _, data_args, args, _ = parse_args(uninterrupted["argv"] + ["--output_dir", out])
    tokenizer = ByteTokenizer(model_max_length=args.model_max_length, padding_side="right")
    datasets = [PretrainDataset(tokenizer, first.model_cfg.vision, manifest_path=m,
                                model_max_length=args.model_max_length)
                for m in (data_args.manifest, data_args.eval_manifest)]
    device = uninterrupted["device"]
    run = drive_pretrain(
        lambda cls: cls(first.model_cfg, args, *datasets, tokenizer, device=device).train(
            resume_from_checkpoint=os.path.join(uninterrupted["out"], "checkpoint-2")), device)
    expected = pretrain_launches(first.model_cfg, 2, 1)
    if device == "cuda" and run["launches"] != expected:
        raise AssertionError(f"pretrain_resume: kernel launches {run['launches']}, expected {expected}")
    from mafed_tpu_torch.models.weights import load_safetensors

    got, want = (load_safetensors(os.path.join(d, "checkpoint-final", "model.safetensors"))
                 for d in (out, uninterrupted["out"]))
    differ = [k for k in want if not torch.equal(got[k], want[k])]
    if set(got) != set(want) or differ:
        raise AssertionError(f"pretrain_resume: checkpoint-final differs from the uninterrupted run's in {differ[:5]}")
    logged, first_logged = _logged(out), _logged(uninterrupted["out"])
    if logged["train/loss"] != first_logged["train/loss"][2:] or logged["eval/loss"] != first_logged["eval/loss"][1:]:
        raise AssertionError(f"pretrain_resume: logged {logged} against {first_logged}")
    emit({"phase": "pretrain_resume", "card": smi, "from": "checkpoint-2", "step_ms": run["step_ms"],
          "seconds": run["wall"], "checkpoint_s": run["trainer"].checkpoint_seconds,
          "checkpoint_final_bit_equal": True, "tensors": len(want), "logged": logged,
          "launches": run["launches"], "expected_launches": expected})
    shutil.rmtree(out)
    return run["launches"]


def phase_pretrain_to_cl(smi: str, pretrain: dict, root: str, model_cfg=None) -> dict:
    """cl_sequence_default's command line with --model_name
    <pretrain out>/checkpoint-final: the model the trainer starts from (its
    first load_params, on the card) equal to the checkpoint's tensors bit for
    bit, and the sequence's checks and launches (572 / 144 / 144) as in
    cl_sequence_default."""
    from mafed_tpu_torch.models.weights import load_safetensors
    from mafed_tpu_torch.trainer.runner import TaskRunner

    ckpt = os.path.join(pretrain["out"], "checkpoint-final")
    loaded = []
    load_params = TaskRunner.load_params

    def record_first(self, params):
        load_params(self, params)
        if not loaded:
            loaded.append({k: v.detach().to("cpu", torch.float32, copy=True) for k, v in self.model.state_dict().items()})

    TaskRunner.load_params = record_first
    try:
        with tempfile.TemporaryDirectory(prefix="pretrain_to_cl_", dir=root) as data:
            write_synthetic_vqa(data, ("taskA", "taskB"), 128, 32)
            run = drive_sequence(cl_sequence_argv(data) + ["--model_name", ckpt], pretrain["device"], model_cfg)
            counts = check_sequence("pretrain_to_cl", run, 128, 32, pretrain["device"], tables=True)
    finally:
        TaskRunner.load_params = load_params
    want = load_safetensors(os.path.join(ckpt, "model.safetensors"))
    (got,) = loaded
    differ = [k for k in want if not torch.equal(got[k], want[k])]
    if set(got) != set(want) or differ:
        raise AssertionError(f"pretrain_to_cl: the trainer's initial model differs from {ckpt} in {differ[:5]}")
    emit({"phase": "pretrain_to_cl", "card": smi, "model_name": "<pretrain out>/checkpoint-final",
          "initial_state_bit_equal": True, "tensors": len(want),
          "accuracy_matrix": run["result"]["accuracy_matrix"], "bwt": run["result"]["bwt"],
          "seconds": {"sequence": run["wall"], **run["trainer"].timings}, "losses": run["losses"],
          "train_ex_per_s": run["train_ex_per_s"], **counts, "launches": run["launches"]})
    return run["launches"]


# --- the host's image decoder ---------------------------------------------------------

def write_photos(root: str, n: int, size=(640, 480)) -> list:
    """`n` COCO-sized photos (640 x 480 landscape, every 3rd 480 x 640
    portrait), half JPEG (quality 90) and half PNG: a gradient, coloured
    blocks and mild noise; written on a thread pool."""
    from concurrent.futures import ThreadPoolExecutor

    from PIL import Image

    os.makedirs(root, exist_ok=True)

    def write(i):
        rng = np.random.default_rng(100 + i)
        w, h = size if i % 3 else size[::-1]
        y, x = np.mgrid[0:h, 0:w].astype(np.float32)
        img = np.stack([x / w * 200, y / h * 200, (x + y) / (w + h) * 200], -1)
        for _ in range(6):
            x0, y0 = int(rng.integers(0, w - 64)), int(rng.integers(0, h - 64))
            img[y0:y0 + int(rng.integers(32, 200)), x0:x0 + int(rng.integers(32, 200))] = rng.integers(0, 256, 3)
        img = np.clip(img + rng.normal(0, 8, size=img.shape), 0, 255).astype(np.uint8)
        path = os.path.join(root, f"{i}.{'jpg' if i % 2 else 'png'}")
        Image.fromarray(img).save(path, **({"quality": 90} if i % 2 else {}))
        return path

    with ThreadPoolExecutor(8) as pool:
        return list(pool.map(write, range(n)))


def _loader_batch_ms(manifest: str, vision_cfg, native: str, batch: int = 128) -> float:
    """Host ms of one pretrain batch of `batch` captions through the
    pretrain trainer's loader (BatchLoader, its 4 workers, collate_pretrain)
    with MAFED_NATIVE_IMAGES=`native`."""
    from mafed_tpu_torch.data.loader import BatchLoader
    from mafed_tpu_torch.pretrain.dataset import PretrainDataset, collate_pretrain

    before = os.environ.get("MAFED_NATIVE_IMAGES")
    os.environ["MAFED_NATIVE_IMAGES"] = native
    try:
        dataset = PretrainDataset(ByteTokenizer(model_max_length=100, padding_side="right"), vision_cfg,
                                  manifest_path=manifest, model_max_length=100)
        loader = BatchLoader(dataset, batch_size=batch, collate=lambda items: collate_pretrain(items, text_len=100),
                             drop_last=True)
        start = time.perf_counter()
        (out,) = list(loader)
        ms = (time.perf_counter() - start) * 1e3
    finally:
        if before is None:
            del os.environ["MAFED_NATIVE_IMAGES"]
        else:
            os.environ["MAFED_NATIVE_IMAGES"] = before
    if out["pixels"].shape != (batch, vision_cfg.img_size, vision_cfg.img_size, 3):
        raise AssertionError(f"image_engine: a pretrain batch of pixels {out['pixels'].shape}")
    return ms


def phase_image_engine(smi: str, n_files: int = 250) -> dict:
    """The C++ image engine (mafed_tpu_torch/native) on the card's host:
    whether it built, and why not if not; `n_files` COCO-sized JPEG and PNG
    files decoded to 224 x 224 through it and through PIL (each decoder's
    seconds, the largest and mean difference of their pixels); and one
    pretrain batch of 128 captions (phase pretrain's images) through the
    trainer's loader with MAFED_NATIVE_IMAGES=1 and =0, in turns. Without
    the engine, PIL's numbers alone."""
    from mafed_tpu_torch.data.images import load_and_resize
    from mafed_tpu_torch.native import engine as native

    start = time.perf_counter()
    eng = native.get_engine()
    build_s = time.perf_counter() - start
    out = {"phase": "image_engine", "card": smi, "built": eng is not None, "failure": native.failure(),
           "build_s": build_s, "files": n_files}
    cfg = VisionConfig()
    with tempfile.TemporaryDirectory(prefix="image_engine_") as root:
        start = time.perf_counter()
        paths = write_photos(os.path.join(root, "photos"), n_files)
        out["write_s"] = time.perf_counter() - start
        decoded = {}
        for name, decode in (("pil", lambda p: load_and_resize(p, cfg, use_native=False)),
                             ("engine", (lambda p: eng.decode(p, cfg.img_size, cfg.crop_pct)) if eng else None)):
            if decode is None:
                continue
            start = time.perf_counter()
            decoded[name] = [decode(p) for p in paths]
            seconds = time.perf_counter() - start
            out[f"{name}_s"] = seconds
            out[f"{name}_images_per_s"] = n_files / seconds
        if eng is not None:
            diffs = [np.abs(a.astype(np.int16) - b.astype(np.int16)) for a, b in zip(decoded["engine"], decoded["pil"])]
            out["engine_vs_pil"] = {
                "max": int(max(d.max() for d in diffs)), "mean": float(np.mean([d.mean() for d in diffs])),
                "max_jpeg": int(max(d.max() for d, p in zip(diffs, paths) if p.endswith(".jpg"))),
                "max_png": int(max(d.max() for d, p in zip(diffs, paths) if p.endswith(".png"))),
                "equal_files": int(sum(not d.any() for d in diffs))}
        manifest, _ = write_caption_manifests(os.path.join(root, "captions"), 128, 0)
        turns = ["1", "0", "0", "1"] if eng is not None else ["0", "0"]
        batch_ms = {"1": [], "0": []}
        for native_flag in turns:
            batch_ms[native_flag].append(_loader_batch_ms(manifest, cfg, native_flag))
        out["pretrain_batch_128_loader_ms"] = {"engine" if k == "1" else "pil": v for k, v in batch_ms.items() if v}
    emit(out)
    return out


# --- named remat policies ------------------------------------------------------------------

REMAT_POLICIES = ("", "attn", "attn_qkv", "attn_mlp", "attn_qkv_mlp", "dots")
# loss and grad norm of each policy's windows against full recompute's (bf16 on the
# card): a policy keeps tensors the recompute would produce from the same inputs
# with the same kernels, so the numbers should agree to the last bit
REMAT_RTOL = 1e-3


def phase_remat_policies(smi: str, windows: int = 5, device: str = "cuda", cfg=None):
    """Five fused MAFED windows of VL-Pythia-410M at phase window's shapes
    under each remat policy, every policy from one snapshot of the weights
    (a fresh optimizer each time); per policy: losses and grad norms against
    full recompute's, ms per window (the mean of the last three), peak GB,
    the flash launches per window (asserted: the forward's recompute drops
    out under the attn policies).
    Returns the launches by head_dim over all policies. `cfg` and `device`
    rehearse it at a tiny size on the CPU (launches unchecked there)."""
    cfg = cfg or model_config_for_preset("410m")
    cuda = device == "cuda"
    n_ce, b, text_len = 3, 16, 80
    model = init_model(cfg, seed=0, device=device)
    snapshot = {k: v.detach().clone() for k, v in model.state_dict().items()}
    layers = cfg.num_hidden_layers
    results, total = {}, at_head_dim(cfg.head_dim, _kernels(0, 0))
    for policy in REMAT_POLICIES:
        model.load_state_dict(snapshot)
        train_cfg = train_config()
        train_cfg.remat_policy = policy
        teacher = make_teacher(model)
        trainable = trainable_parameters(model)
        opt = build_optimizer(train_cfg, trainable)
        state = TrainState(0, model, set_schedule(opt.init(trainable), 0, 100))
        step = make_mafed_window_step(cfg, train_cfg, opt, n_ce=n_ce, device=device)
        gen = torch.Generator().manual_seed(2)
        mbs = [example_batch(gen, cfg, b, text_len) for _ in range(n_ce + 1)]
        ce = {k: torch.stack([mb[k] for mb in mbs[:n_ce]]).to(device) for k in mbs[0]}
        distill = {k: v.to(device) for k, v in mbs[n_ce].items()}
        lang = torch.full((layers - 1,), 0.5, device=device)
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        A.reset_launches()
        times, history = [], []
        for _ in range(windows):
            start = time.perf_counter()
            state, m = step(state, teacher, ce, distill, lang)
            if cuda:
                torch.cuda.synchronize()
            times.append((time.perf_counter() - start) * 1e3)
            history.append({k: float(m[k]) for k in ("loss", "grad_norm")})
        launches = launches_by_dim()
        # a window: forward in the CE (L), student (L) and teacher (L - 2) passes, the
        # forward's recompute in backward for the 2 L differentiated layers unless the
        # policy keeps the attention; the backward kernels once per differentiated layer
        recompute = 0 if policy.startswith("attn") else 2 * layers
        expected = at_head_dim(cfg.head_dim, _kernels(windows * (2 * layers + layers - 2 + recompute),
                                                      windows * 2 * layers))
        if cuda and launches != expected:
            raise AssertionError(f"remat_policies ({policy!r}): kernel launches {launches}, expected {expected}")
        total = _sum_launches([total, launches])
        results[policy] = {"window_ms": times, "ms_per_window": sum(times[2:]) / (windows - 2),
                           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9 if cuda else None,
                           "metrics": history,
                           "launches_per_window": {k: v // windows for k, v in
                                                  launches.get(cfg.head_dim, _kernels(0, 0)).items()}}
        del step, state, opt, teacher
        if cuda:
            free_device_memory()
    base = results[""]["metrics"]
    for policy, res in results.items():
        err = max(abs(g[k] - w[k]) / abs(w[k]) for g, w in zip(res["metrics"], base) for k in w)
        res["max_rel_err_vs_full"] = err
        if not all(np.isfinite(v) for h in res["metrics"] for v in h.values()) or err > REMAT_RTOL:
            raise AssertionError(f"remat_policies ({policy!r}): {res['metrics']} against full recompute's {base}")
    emit({"phase": "remat_policies", "card": smi, "preset": "410m", "n_ce": n_ce, "batch": b, "text_len": text_len,
          "rtol": REMAT_RTOL, "policies": results})
    del model, snapshot
    return total


# --- CLIP ViT-L/14-336 tower: greedy decode and validate_vqa ------------------------------

def clip_l336_config() -> ModelConfig:
    """VL-Pythia-410M with the CLIP ViT-L/14-336 tower (openai/clip-vit-large-patch14-336's
    geometry: hidden 1024, 24 layers, 16 heads of 64, MLP 4096, patch 14, image 336,
    577 tokens) and the reference's feature select: hidden_states[-2], CLS dropped."""
    vision = VisionConfig(name="openai/clip-vit-large-patch14-336", backbone="clip", img_size=336, patch_size=14,
                          embed_dim=1024, depth=24, num_heads=16, mlp_ratio=4.0, use_rot_pos_emb=False,
                          swiglu_mlp=False, scale_mlp=False, scale_attn_inner=False, layer_norm_eps=1e-5,
                          crop_pct=1.0)
    return model_config_for_preset("410m", vision=vision, vision_encoder_name=vision.name, select_layer=-2,
                                   select_feature="patch")


# the tower's selected hidden state on the card (bf16, the flash kernel) against
# the port on the CPU (float32, the plain version), relative norm error
CLIP_TOWER_RTOL = 3e-2


def phase_clip_eval(smi: str, gen) -> dict:
    """Greedy decode and validate_vqa of VL-Pythia-410M + CLIP-L/14-336 at full
    width and depth (bf16 weights from a seed; batch 32 of uint8 pixels at
    336, text 64 with 16 left-padded positions, 10 new tokens), the launches
    a batch asserted (24 non-causal forwards at 577 tokens, 24 causal at 576
    + 64); the tower's hidden_states[-2] on 2 images against the port's
    float32 CPU run; the tower's flash forward at [32, 16, 577, 64] against
    its plain version (atol = rtol = 2e-2) and timed beside it, SDPA and its
    bound. Returns the launches by head_dim."""
    cfg = clip_l336_config()
    b, text_len, pad, max_new, n = 32, 64, 16, 10, 4
    model = init_model(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    decode = make_greedy_decoder(cfg, max_new_tokens=max_new, eos_token_id=0)
    batches = decode_batches(cfg, n + 1, b, text_len, pad, seed=4)
    host = [{k: torch.from_numpy(v) for k, v in bt.items()} for bt in batches]
    run_decode(decode, model, host[:1])  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    A.reset_launches()
    toks, ms = run_decode(decode, model, host[1:])
    launches = launches_by_dim()
    expected = at_head_dim(64, _kernels(n * (cfg.vision.depth + cfg.num_hidden_layers), 0))
    if launches != expected:
        raise AssertionError(f"clip_eval: kernel launches {launches}, expected {expected}")
    if any(t.shape != (b, max_new) or t.min() < 0 or t.max() >= cfg.vocab_size for t in toks):
        raise AssertionError(f"clip_eval: tokens of shape {toks[0].shape} or out of the vocabulary")
    peak = torch.cuda.max_memory_allocated() / 1e9
    invariance = check_cache_invariance(model, cfg, batches[1], toks[0], eos=0)

    # the selected hidden state: card (bf16) against the port on the CPU (float32)
    pixels = torch.from_numpy(batches[1]["pixels"][:2])
    normalize = make_normalizer(cfg.vision)
    with torch.inference_mode():
        card = V.get_patch_embeddings(model, prep_pixels({"pixels": pixels.cuda()}, normalize, torch.bfloat16))
        tower = clip_vit.CLIPVisionModel(cfg.vision, device="cpu")
        tower.load_state_dict({k: v.float().cpu() for k, v in model.vision_encoder.state_dict().items()})
        hidden = tower.hidden_states(prep_pixels({"pixels": pixels}, normalize, torch.float32), dtype=torch.float32)
        want = hidden[cfg.select_layer][:, 1:]  # select_feature "patch": CLS dropped
        del tower, hidden
    tower_err = _rel_err(card, want)
    if card.shape != (2, 576, 1024) or not tower_err <= CLIP_TOWER_RTOL:
        raise AssertionError(f"clip_eval: tower features {tuple(card.shape)}, relative error {tower_err} vs the CPU")

    tokenizer = ByteTokenizer()
    loader = decode_batches(cfg, 3, b, text_len, pad, seed=5)
    loader[-1] = {k: v[:20] for k, v in loader[-1].items()}
    for i, batch in enumerate(loader):
        batch["qids"] = [f"q{i}_{j}" for j in range(len(batch["input_ids"]))]
        batch["answers"] = [["yes", "no", "2"]] * len(batch["input_ids"])
    val_log, results = validate_vqa(model, decode, loader, tokenizer, batch_size=b)
    if val_log["valid/n_ex"] != 2 * b + 20 or len(results) != 2 * b + 20 or not 0 <= val_log["valid/acc"] <= 1:
        raise AssertionError(f"clip_eval validate_vqa: {val_log}, {len(results)} results")
    del model
    free_device_memory()
    tower_kernel = _fwd_timing(gen, 32, 16, 577, 64, False, None)
    emit({"phase": "clip_eval", "card": smi, "vision": cfg.vision.name, "tower_tokens": cfg.vision.num_patches + 1,
          "select_layer": cfg.select_layer, "batch": b, "text_len": text_len, "left_pad": pad,
          "max_new_tokens": max_new, "timed_batches": n, "ms_per_batch": ms, "examples_per_s": b / (ms / 1e3),
          "peak_memory_gb": peak, "launches": launches, "expected_launches": expected,
          "tokens_row0": toks[0][0].tolist(), "cache_invariance": invariance,
          "tower_rel_err_vs_cpu_f32": tower_err, "tower_rtol": CLIP_TOWER_RTOL, "validate": val_log,
          "tower_flash_fwd": tower_kernel})
    return launches


# --- profiling: a traced fit of the shipped config --------------------------------------------

PROFILE_QUESTIONS = 384  # task 0 of 24 batches of 16: 6 windows, the trace over batches 10-23


def drive_fit(argv, device, model_cfg) -> dict:
    """parse_with_config + ContinualLearningTrainer.main over `argv`, the
    launch counts set to 0 just before and read just after."""
    cfg = parse_with_config(build_arg_parser(), argv)
    model_cfg = model_cfg or ModelConfig.from_json(cfg.model_config)
    A.reset_launches()
    start = time.perf_counter()
    trainer = continual.ContinualLearningTrainer(cfg, model_cfg=model_cfg, synthetic_images=True, device=device)
    result = trainer.main()
    wall = time.perf_counter() - start
    return {"cfg": cfg, "result": result, "wall": wall, "fit_s": trainer.timings["fit"][0],
            "steps": trainer.fit_logs[0]["steps"], "launches": launches_by_dim()}


def phase_profile(smi: str, device: str = "cuda", model_cfg=None, n_train: int = PROFILE_QUESTIONS) -> dict:
    """The shipped config through ContinualLearningTrainer.main on one task of
    `n_train` questions (no resume bundles), without and with --profile_dir:
    the trace file exists and names the three flash kernels; the two runs
    take the same steps and launches; the profiled fit's seconds against
    the unprofiled one's. `model_cfg` and `device` rehearse it on the CPU.
    Returns the profiled run's launches by head_dim."""
    runs = {}
    with tempfile.TemporaryDirectory(prefix="profile_") as root:
        write_synthetic_vqa(root, ("taskA",), n_train, 32)
        argv = cl_sequence_argv(root) + ["--tasks", "taskA", "--epochs", "1", "--resume_bundle_every", "0"]
        # in turns: plain, profiled, plain
        for name, extra in (("plain", []), ("profiled", ["--profile_dir", os.path.join(root, "prof")]),
                            ("plain_again", [])):
            runs[name] = drive_fit(argv + ["--output_dir", os.path.join(root, name)] + extra, device, model_cfg)
            if device == "cuda":
                free_device_memory()
        trace = os.path.join(root, "prof", "trace.json")
        if not os.path.exists(trace):
            raise AssertionError("profile: no trace file under --profile_dir")
        with open(trace) as f:
            text = f.read()
    names = {k: text.count(k) for k in ("flash_fwd_kernel", "flash_bwd_dkv_kernel", "flash_bwd_dq_kernel")}
    if device == "cuda" and not all(names.values()):
        raise AssertionError(f"profile: the trace names the flash kernels {names} times")
    prof = runs["profiled"]
    for name in ("plain", "plain_again"):
        if runs[name]["steps"] != prof["steps"] or runs[name]["launches"] != prof["launches"]:
            raise AssertionError(f"profile: the profiled run took {prof['steps']} / {prof['launches']}, "
                                 f"the {name} one {runs[name]['steps']} / {runs[name]['launches']}")
    plain_fit = (runs["plain"]["fit_s"] + runs["plain_again"]["fit_s"]) / 2
    emit({"phase": "profile", "card": smi, "config": SHIPPED_CONFIG, "train_questions": n_train,
          "steps": prof["steps"], "trace_mb": len(text) / 1e6, "trace_kernel_mentions": names,
          "fit_s": {name: run["fit_s"] for name, run in runs.items()},
          "profiled_over_plain": prof["fit_s"] / plain_fit,
          "wall_s": {name: run["wall"] for name, run in runs.items()}, "launches": prof["launches"]})
    return prof["launches"]


# --- the CKA sweep over a finished sequence ---------------------------------------------------

def phase_cka_sweep(smi: str, default_run: dict, device: str = "cuda", n_val: int = 32) -> dict:
    """analysis.sweep.main over cl_sequence_default's experiment directory at
    --max_batches 2: L + 1 layers, values in [0, 1], launches as computed
    (both checkpoints' tower and decoder forwards on the probe task's val
    batches); and CKA(a, a) = 1 within 1e-5 on one layer's text features on
    the card. Returns the sweep's launches by head_dim."""
    from mafed_tpu_torch.analysis import cka as tcka
    from mafed_tpu_torch.analysis import sweep as tsweep
    from mafed_tpu_torch.analysis.representation_similarity import collect_hidden_states

    cfg, model_cfg = default_run["cfg"], default_run["model_cfg"]
    out = os.path.join(cfg.output_dir, "log", "cka_report.json")
    A.reset_launches()
    start = time.perf_counter()
    report = tsweep.main(["--experiment_dir", cfg.output_dir, "--max_batches", "2", "--synthetic_images",
                          "--device", device])
    seconds = time.perf_counter() - start
    launches = launches_by_dim()
    layers = model_cfg.num_hidden_layers + 1
    values = report["avg_text_cka"] + report["avg_image_cka"]
    if report["layers"] != list(range(layers)) or not all(0.0 <= v <= 1.0 + 1e-6 for v in values) or \
            not os.path.exists(out):
        raise AssertionError(f"cka_sweep: layers {report['layers']}, values {values}")
    val_batches = min(2, math.ceil(n_val / cfg.val_batch_size))
    expected = at_head_dim(64, _kernels(2 * val_batches * (model_cfg.vision.depth + model_cfg.num_hidden_layers), 0))
    if device == "cuda" and launches != expected:
        raise AssertionError(f"cka_sweep: kernel launches {launches}, expected {expected}")
    # CKA of a representation with itself, on the card
    model = V.VLPythia(model_cfg, device=device)
    model.vision_encoder.to(torch.bfloat16)
    model.load_state_dict(load_task_checkpoint(os.path.join(cfg.output_dir, "ckpt", f"{cfg.tasks[-1]}_best.safetensors")))
    feats = collect_hidden_states(model, model_cfg, tsweep._batches_factory(cfg, model_cfg, cfg.tasks[0], True)(), 1)
    layer = model_cfg.num_hidden_layers // 2
    self_cka = tcka.feature_space_linear_cka(feats[layer]["text"], feats[layer]["text"])
    if abs(self_cka - 1.0) > 1e-5 or feats[layer]["text"].device.type != device:
        raise AssertionError(f"cka_sweep: CKA(a, a) = {self_cka} on layer {layer}")
    del model, feats
    emit({"phase": "cka_sweep", "card": smi, "experiment": "cl_sequence_default", "pairs": report["pairs"],
          "layers": len(report["layers"]), "seconds": seconds, "avg_text_cka": report["avg_text_cka"],
          "avg_image_cka": report["avg_image_cka"], "avg_ti_ratio": report["avg_ti_ratio"],
          "self_cka": {"layer": layer, "value": self_cka}, "tf32": torch.backends.cuda.matmul.allow_tf32,
          "launches": launches, "expected_launches": expected})
    return launches


# --- phase multiprocess: data parallelism over torch.distributed -------------------------------------------

# The card's machine has one H100 and NCCL refuses two ranks on one card, so
# the phase runs two ranks on cuda:0 over gloo, which stages CUDA tensors
# through the host: a check of correctness, not a measure of scaling.
MP_WORLD, MP_BACKEND, MP_DEVICE = 2, "gloo", "cuda:0"
# Phases multiprocess and tensor_parallel at full width but cut in depth, every check kept, their
# one-process references run at the same depth: the 410M windows and the CL runs (the shipped config's
# model) at MP_LAYERS of 24 layers, the 1B windows at TP_WINDOW_LAYERS of 16 (ranks share one card over
# gloo: these phases check correctness, and at full depth they took ~45 % of the script's time)
MP_LAYERS = 6
TP_WINDOW_LAYERS = 4
MP_WAIT_S = 900  # each rank's bound, the SIGTERM's wait included
MP_SIGTERM_MAX_WINDOWS = 40  # windows the ranks run while rank 1 waits for its SIGTERM
# the CL runs keep only the preemption's bundle: epoch-end bundles (~9 GB, written
# by rank 0 while rank 1 waits) would add ~45 s to the phase
MP_CL_SWITCHES = ["--resume_bundle_every", "0"]
# the CL runs stop after task 0's two windows: by the countdown on [2, 1], by a SIGTERM to rank 1 on [2, 2]
CL_INTERRUPT_AFTER = 2
# Pretraining: two ranks on one card hold two copies of weights and optimizer
# state, and one process at batch 128 peaks at 75.5 GB, so the pair trains
# at a global batch of 64 (32 a rank) against one process at 64: two updates,
# the first at lr 0 (the schedule's warmup step).
MP_PRETRAIN_GLOBAL = 64
# Against one process (bf16 compute; the ranks' half batches round otherwise):
# the window metrics (loss, CE, distill, grad norm), the CL sequence's logged
# losses and the pretraining losses within MP_METRIC_RTOL, bf16's relative
# resolution; the parameters' distance
# from one process's, over the length of one process's own update, within
# MP_UPDATE_RTOL; no element farther than AdamW can move it in opposite
# directions, 2.02 lr an update (|m^|/sqrt(v^) <= 1.004 in the first three
# updates). The phase prints beside them the spread of one process run twice
# on the same rows in the two orders (the ranks' interleave concatenated).
MP_METRIC_RTOL = 2.0 ** -8
MP_UPDATE_RTOL = 0.05
# pretraining under tensor parallelism against one process on the same rows and weights
TP_PRETRAIN_LOSS_RTOL = 1e-3


def equal_on_every_rank(tensors) -> bool:
    """Whether every rank holds `tensors` equal to rank 0's, bit for bit."""
    from mafed_tpu_torch.core import dist as D

    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    ref = flat.clone()
    D.broadcast_from_main_([ref])
    return D.process_reduce_sum(float(torch.equal(flat, ref)))[0] == D.process_count()


def replicated_parameters(model) -> list:
    """The trainable parameters every rank holds whole: all of them, or
    under tensor parallelism those param_partition_spec does not split."""
    from mafed_tpu_torch.core.mesh import param_partition_spec

    return [p for k, p in trainable_parameters(model).items()
            if getattr(model, "tp", None) is None or param_partition_spec(k) is None]


def param_distance(got: dict, want: dict, before: dict, bound=None, device: str = "cpu") -> dict:
    """max |got - want|, and ||got - want|| / ||want - before|| (the distance
    from the reference over the length of the reference's update), over
    want's keys, computed on `device` a tensor at a time (at 1B, minutes'
    worth of host arithmetic otherwise); with `bound`, raises past it or
    past MP_UPDATE_RTOL."""
    max_abs, sq_diff, sq_update = 0.0, 0.0, 0.0
    for k, w in want.items():
        w = w.to(device, torch.float32)
        d = got[k].to(device, torch.float32) - w
        max_abs = max(max_abs, float(d.abs().max()))
        sq_diff += float(d.double().square().sum())
        sq_update += float((w - before[k].to(device, torch.float32)).double().square().sum())
    out = {"max_abs_diff": max_abs, "update_rel_diff": math.sqrt(sq_diff / sq_update)}
    if bound is not None:
        out.update(max_abs_bound=bound, update_rtol=MP_UPDATE_RTOL)
        if max_abs > bound or out["update_rel_diff"] > MP_UPDATE_RTOL:
            raise AssertionError(f"multiprocess: parameters against one process's {out}")
    return out


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def mp_windows(rank: int, world: int, device: str, root: str, sigterm: bool, rows=None) -> dict:
    """Phase window's three 410M MAFED windows (its seeded snapshot and rows),
    each rank on its interleaved 16 / world of the 16 rows a microbatch (or
    on `rows`, an index); rank 0 of several saves the trainable parameters
    after them, one process (the reference) returns them and those before.
    With `sigterm`, the ranks go on with windows, checking the agreed
    preemption flag after each, until the SIGTERM that only rank 1 receives
    stops them both."""
    from mafed_tpu_torch.core import dist as D

    cfg = model_config_for_preset("410m", num_hidden_layers=MP_LAYERS)
    n_ce, b, text_len, windows = 3, 16, 80, 3
    model = init_model(cfg, seed=0, device=device)
    D.broadcast_model_(model)
    step, state, teacher, ce, distill, lang = window_setup(
        cfg, model, n_ce, b, text_len, torch.Generator().manual_seed(2), device)
    rows = slice(rank, b, world) if rows is None else rows  # the loader's interleave of a global batch
    ce, distill = {k: v[:, rows] for k, v in ce.items()}, {k: v[rows] for k, v in distill.items()}
    trainable = trainable_parameters(model)
    out = {"before": {k: p.detach().cpu().clone() for k, p in trainable.items()}} if world == 1 else {}
    _sync(device)
    A.reset_launches()
    times, history = [], []
    for _ in range(windows):
        start = time.perf_counter()
        state, m = step(state, teacher, ce, distill, lang)
        _sync(device)
        times.append((time.perf_counter() - start) * 1e3)
        history.append({k: float(m[k]) for k in ("loss", "ce_loss", "distill_loss", "grad_norm")})
    launches = launches_by_dim()
    expected = window_launches(cfg, windows)
    if torch.device(device).type == "cuda" and launches != expected:
        raise AssertionError(f"multiprocess rank {rank}: window launches {launches}, expected {expected}")
    out.update({"window_ms": times, "ms_per_window": sum(times[1:]) / (windows - 1), "metrics": history,
                "launches": launches, "ranks_equal": equal_on_every_rank(trainable.values())})
    if world == 1:
        out["trainable"] = {k: p.detach().cpu().clone() for k, p in trainable.items()}
    elif rank == 0:
        save_task_checkpoint(trainable, os.path.join(root, "window_trainable.safetensors"))
    if sigterm:
        A.reset_launches()
        if rank == 1:
            open(os.path.join(root, "sigterm_ready"), "w").close()
        for i in range(MP_SIGTERM_MAX_WINDOWS):
            state, _ = step(state, teacher, ce, distill, lang)
            if preempt.sync_preemption_requested(windows + i + 1):
                break
        else:
            raise AssertionError(f"multiprocess rank {rank}: no SIGTERM stopped the windows")
        out["sigterm"] = {"stopped_after_update": windows + i + 1, "signal_here": preempt.preemption_requested()}
        out["sigterm_launches"] = launches_by_dim()
        preempt.clear()
    return out


def mp_cl_model_config(argv) -> ModelConfig:
    """The model of `argv`'s config file (the shipped config's 410M) cut to MP_LAYERS layers."""
    cfg = parse_with_config(build_arg_parser(), argv)
    return dataclasses.replace(ModelConfig.from_json(cfg.model_config), num_hidden_layers=MP_LAYERS)


def cl_reference(root: str, device: str) -> dict:
    """The one-process run that cl_runs' ranks are held to: cl_sequence_default's
    command line plus MP_CL_SWITCHES on mp_cl_model_config's model, writing
    no checkpoint. Returns its accuracy matrix, logged losses and launches."""
    argv = cl_sequence_argv(os.path.join(root, "data")) + MP_CL_SWITCHES
    run = drive_sequence(argv + ["--output_dir", os.path.join(root, "cl_one_process")], device,
                         mp_cl_model_config(argv), keep_checkpoints="none", write=())
    return {"accuracy_matrix": run["result"]["accuracy_matrix"], "losses": run["losses"],
            "launches": run["launches"], "seconds": run["wall"], "layers": run["model_cfg"].num_hidden_layers}


def cl_runs(rank: int, device: str, root: str, name: str, extra, interrupt: str, check_best: bool = False) -> dict:
    """cl_sequence_default's command line (plus MP_CL_SWITCHES and `extra`)
    on mp_cl_model_config's model,
    three times over the ranks: uninterrupted, into ROOT/<name>_full; stopped
    after CL_INTERRUPT_AFTER updates by `interrupt` ("countdown": the
    preemption countdown on every rank; "sigterm": a SIGTERM to rank 1
    alone, which every rank's vote turns into one bundle and exit 143); then
    resumed from that bundle with --resume_from_checkpoint, whose final
    trainable parameters (gathered under tensor parallelism) must equal the
    uninterrupted run's bit for bit. The runs write only the files they
    read back: the bundle and, with `check_best`, the uninterrupted run's
    last best checkpoint, which rank 0 reads into a VLPythia as one process
    reads it and holds against the gathered model."""
    import signal

    argv = cl_sequence_argv(os.path.join(root, "data")) + MP_CL_SWITCHES + list(extra)
    pre_out = os.path.join(root, f"{name}_pre")
    last_best = "taskB_best.safetensors"
    runs, ticks = {}, []
    tick = preempt.tick_update

    def counted_tick():
        tick()
        ticks.append(1)
        if interrupt == "sigterm" and rank == 1 and len(ticks) == CL_INTERRUPT_AFTER:
            os.kill(os.getpid(), signal.SIGTERM)

    for run_name, out_argv in (("full", ["--output_dir", os.path.join(root, f"{name}_full")]),
                               ("stopped", ["--output_dir", pre_out]),
                               ("resumed", ["--output_dir", pre_out, "--resume_from_checkpoint",
                                            os.path.join(pre_out, "resume")])):
        stopped = run_name == "stopped"
        sigterm = stopped and interrupt == "sigterm"
        preempt.tick_update = counted_tick if stopped else tick
        try:
            # with the SIGTERM, a countdown no run reaches: drive_sequence then takes its exit 143
            run = drive_sequence(argv + out_argv, device, mp_cl_model_config(argv), keep_checkpoints="none",
                                 preempt_after=(10 ** 9 if sigterm else CL_INTERRUPT_AFTER) if stopped else None,
                                 write=(last_best,) if check_best and run_name == "full" else ())
        finally:
            preempt.tick_update = tick
        trainer = run.pop("trainer")
        run["primed"], run["teacher_cache"] = trainer.primed, trainer.strategy.teacher_cache_log
        run["stages"], run["steps"] = trainer.timings, [log["steps"] for log in trainer.fit_logs]
        if stopped:
            with open(os.path.join(pre_out, "resume", "fit_state.json")) as f:
                run["bundle"] = {k: v for k, v in json.load(f).items() if k in ("task_id", "epoch", "batches_done")}
            run["updates_here"] = len(ticks)
        else:
            run["trainable"] = trainer.runner.host_trainable()
            run["ranks_equal"] = equal_on_every_rank(replicated_parameters(trainer.runner.model))
            if check_best and run_name == "full" and rank == 0:
                path = os.path.join(root, f"{name}_full", "ckpt", last_best)
                one_process = V.VLPythia(trainer.model_cfg, device="meta")
                one_process.load_state_dict(load_task_checkpoint(path), strict=True, assign=True)
                state = one_process.state_dict()
                run["best_checkpoint_equal"] = all(torch.equal(state[k], v) for k, v in run["trainable"].items())
                del one_process, state
        runs[run_name] = run
        del trainer, run
        free_device_memory()
    full, resumed = runs["full"], runs["resumed"]
    return {
        "accuracy_matrix": full["result"]["accuracy_matrix"], "bwt": full["result"]["bwt"],
        "resumed_accuracy_matrix": resumed["result"]["accuracy_matrix"],
        "resumed_equal": all(torch.equal(resumed["trainable"][k], v) for k, v in full["trainable"].items()),
        "ranks_equal": [full["ranks_equal"], resumed["ranks_equal"]], "bundle": runs["stopped"]["bundle"],
        "stopped_updates_here": runs["stopped"]["updates_here"],
        "best_checkpoint_equal": full.get("best_checkpoint_equal"),
        "images_primed": full["primed"], "teacher_cache": full["teacher_cache"],
        "steps": full["steps"], "losses": full["losses"], "seconds": {k: run["wall"] for k, run in runs.items()},
        "stage_seconds": {k: run["stages"] for k, run in runs.items()},
        "launches": {k: run["launches"] for k, run in runs.items()},
    }


def mp_pretrain(root: str, world: int, device: str, mesh=(-1, 1)) -> dict:
    """Pretraining through its entry point: two updates at a global batch of
    MP_PRETRAIN_GLOBAL (MP_PRETRAIN_GLOBAL / world a rank's share, the rows
    split over its data group of `mesh`), the first at lr 0 (the schedule's
    warmup step), no eval and no checkpoint but checkpoint-final; its
    launches as computed."""
    from mafed_tpu_torch import pretrain_vlpythia as cli
    from mafed_tpu_torch.core.dist import process_count

    out = os.path.join(root, f"pretrain_{world}" + ("" if mesh[-1] == 1 else f"_tp{mesh[-1]}"))
    argv = ["--manifest", os.path.join(root, "captions", "train.jsonl"), "--output_dir", out,
            "--allow_tokenizer_fallback", "--per_device_train_batch_size", str(MP_PRETRAIN_GLOBAL // world),
            "--model_max_length", "100", "--num_train_epochs", "1", "--save_steps", "2", "--eval_steps", "2",
            "--device", device, "--mesh_shape", *map(str, mesh)]
    cuda = torch.device(device).type == "cuda"
    _sync(device)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    A.reset_launches()
    start = time.perf_counter()
    state = cli.train(argv)
    _sync(device)
    wall = time.perf_counter() - start
    launches = launches_by_dim()
    expected = pretrain_launches(state.model.cfg, 2, 0)
    if state.step != 2 or (cuda and launches != expected):
        raise AssertionError(f"multiprocess pretrain: {state.step} updates, launches {launches}, expected {expected}")
    result = {"seconds": wall, "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9 if cuda else None,
              "launches": launches, "out": out,
              "ranks_equal": equal_on_every_rank(replicated_parameters(state.model))}
    if process_count() == 1:  # the reference: also the parameters both runs started from
        from mafed_tpu_torch.pretrain.trainer import PretrainConfig

        start_model = init_model(state.model.cfg, seed=PretrainConfig().seed, device=device)
        result["before"] = {k: p.detach().cpu() for k, p in trainable_parameters(start_model).items()}
    if process_count() == 1 or int(os.environ["RANK"]) == 0:
        result["loss"] = _logged(out)["train/loss"]
    return result


def mp_worker(argv) -> int:
    """One rank of phase multiprocess:
    python3 chip_smoke.py --mp-worker RANK WORLD PORT MODE ROOT BACKEND DEVICE.
    MODE "all": process_reduce_sum, the windows and the SIGTERM, the CL
    runs, pretraining; "windows": the first two; "tp_..." a part of phase
    tensor_parallel (`tp_worker`). Writes ROOT/rank<RANK>_<MODE>.json."""
    rank, world, port, mode, root, backend, device = int(argv[0]), int(argv[1]), argv[2], argv[3], *argv[4:7]
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=port)
    from mafed_tpu_torch.core import dist as D

    torch.backends.cuda.matmul.allow_tf32 = False  # as phase_device sets it in the one-process reference
    torch.backends.cudnn.allow_tf32 = False
    preempt.install_handlers()
    D.maybe_initialize_distributed(backend=backend, device=device)
    print(json.dumps({"rank": rank, "backend": torch.distributed.get_backend(), "device": device}), flush=True)
    out = {"rank": rank, "backend": torch.distributed.get_backend(), "device": device,
           "reduce_sum": list(D.process_reduce_sum(rank + 1.0, 10.0))}
    if mode.startswith("tp_"):
        out.update(tp_worker(rank, world, device, root, mode))
    else:
        out["window"] = mp_windows(rank, world, device, root, sigterm=mode == "all")
    if mode == "all":
        free_device_memory()
        out["cl"] = cl_runs(rank, device, root, "cl", [], "countdown")
        free_device_memory()
        out["pretrain"] = mp_pretrain(root, world, device)
    D.barrier("multiprocess_done")
    torch.distributed.destroy_process_group()
    with open(os.path.join(root, f"rank{rank}_{mode}.json"), "w") as f:
        json.dump(out, f)
    return 0


def run_ranks(root: str, mode: str, backend: str, devices) -> list:
    """Start one `mp_worker` a device, on a free port; in mode "all", send
    SIGTERM to rank 1 alone once it waits for one. Any rank that fails or
    outlasts MP_WAIT_S fails the phase, and every rank still alive is killed.
    Returns each rank's result."""
    import signal
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    here = os.path.dirname(os.path.abspath(__file__))
    procs, logs = [], []
    deadline = time.time() + MP_WAIT_S
    try:
        for rank, device in enumerate(devices):
            logs.append(open(os.path.join(root, f"rank{rank}_{mode}.log"), "w"))
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--mp-worker", str(rank), str(len(devices)), str(port),
                 mode, root, backend, device], cwd=here, stdout=logs[-1], stderr=subprocess.STDOUT))
        if mode == "all":
            ready = os.path.join(root, "sigterm_ready")
            while not os.path.exists(ready) and all(p.poll() is None for p in procs):
                if time.time() > deadline:
                    raise AssertionError("multiprocess: rank 1 never waited for its SIGTERM")
                time.sleep(0.05)
            if os.path.exists(ready):
                procs[1].send_signal(signal.SIGTERM)
        for p in procs:
            p.communicate(timeout=max(1.0, deadline - time.time()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
        for log in logs:
            log.close()
    results = []
    for rank, p in enumerate(procs):
        if p.returncode != 0:
            with open(os.path.join(root, f"rank{rank}_{mode}.log")) as f:
                tail = f.read()[-4000:]
            raise AssertionError(f"multiprocess: rank {rank} ({mode}) exited with {p.returncode}:\n{tail}")
        with open(os.path.join(root, f"rank{rank}_{mode}.json")) as f:
            results.append(json.load(f))
    return results


def _window_check(name: str, ranks: list, reference: dict) -> dict:
    """Each rank's windows against the one-process reference of phase
    window: metrics equal between the ranks, within MP_METRIC_RTOL of the
    reference; parameters equal between the ranks (checked on the ranks)."""
    windows = [r["window"] for r in ranks]
    if not all(w["ranks_equal"] for w in windows):
        raise AssertionError(f"{name}: trainable parameters differ between the ranks after the windows")
    if any(w["metrics"] != windows[0]["metrics"] for w in windows):
        raise AssertionError(f"{name}: the ranks' window metrics differ: {[w['metrics'] for w in windows]}")
    rel = {k: max(abs(got[k] - want[k]) / abs(want[k]) for got, want in zip(windows[0]["metrics"],
                                                                         reference["metrics"]))
           for k in reference["metrics"][0]}
    if max(rel.values()) > MP_METRIC_RTOL:
        raise AssertionError(f"{name}: window metrics against one process, relative {rel} > {MP_METRIC_RTOL}")
    return {"metrics": windows[0]["metrics"], "metric_rel_err_vs_one_process": rel, "metric_rtol": MP_METRIC_RTOL,
            "ms_per_window_each_rank": [w["ms_per_window"] for w in windows],
            "ms_per_window_one_process": reference["ms_per_window"], "launches_each_rank": windows[0]["launches"]}


def _check_cl_runs(name: str, cl: list, default_losses: dict) -> dict:
    """`cl_runs`' results on every rank: the resumed run bit-equal to the
    uninterrupted one, with its accuracy matrix; the ranks' (replicated)
    parameters equal after both; every rank stopped after CL_INTERRUPT_AFTER
    updates into one bundle (task 0, its two windows of 4 batches); the
    uninterrupted run's logged losses within MP_METRIC_RTOL of one process's
    (`default_losses`). Returns their largest relative error by task."""
    if not all(c["resumed_equal"] and all(c["ranks_equal"]) for c in cl) or \
            any(c["resumed_accuracy_matrix"] != c["accuracy_matrix"] for c in cl):
        raise AssertionError(f"{name}: the resumed sequence differs from the uninterrupted one, or the ranks' "
                             f"parameters differ: {[(c['resumed_equal'], c['ranks_equal']) for c in cl]}")
    bundle = {"task_id": 0, "epoch": 0, "batches_done": 4 * CL_INTERRUPT_AFTER}
    if any(c["bundle"] != bundle or c["stopped_updates_here"] != CL_INTERRUPT_AFTER for c in cl):
        raise AssertionError(f"{name}: the ranks stopped apart or elsewhere: "
                             f"{[(c['bundle'], c['stopped_updates_here']) for c in cl]}, expected {bundle}")
    losses = cl[0]["losses"]
    err = {task: _max_rel(losses[task], want) for task, want in default_losses.items()}
    if losses.keys() != default_losses.keys() or any(len(losses[t]) != len(w) for t, w in default_losses.items()) \
            or not all(e <= MP_METRIC_RTOL for e in err.values()):
        raise AssertionError(f"{name}: the CL losses {losses} against one process's {default_losses}")
    return err


def phase_multiprocess(smi: str, root: str, device: str = "cuda") -> tuple:
    """Data parallelism over torch.distributed at full width (cut in depth:
    MP_LAYERS): two ranks on the one card over gloo (MP_BACKEND, MP_DEVICE).
    process_reduce_sum on known values; phase window's three 410M MAFED
    windows against their one-process run (the reference, run here first on
    `device`): the ranks bit-equal, within the stated tolerances of one
    process, 5 L - 2 / 2 L / 2 L launches a window on each rank; a SIGTERM to
    rank 1 alone stops both after the same window; the two-task CL sequence
    of cl_sequence_default's command line (the teacher cache primed by both
    ranks into one directory), its accuracy matrix beside the one-process
    one (`cl_reference`, run here first), its logged losses within
    MP_METRIC_RTOL of the one-process ones, then preempted by the countdown
    and resumed bit-equal (`cl_runs`); one pretraining update at a global
    MP_PRETRAIN_GLOBAL against one process. Then the NCCL windows, on two
    cards only. Returns the launches of every rank and of the references,
    the one-process pretraining run and the one-process CL run."""
    write_synthetic_vqa(os.path.join(root, "data"), ("taskA", "taskB"), 128, 32)
    write_caption_manifests(os.path.join(root, "captions"), 2 * MP_PRETRAIN_GLOBAL, 0)
    # the one-process references, before the ranks take the card: the CL sequence, the windows on the
    # rows in their order and in the ranks' (the spread of one process), then pretraining
    cl_one = cl_reference(root, device)
    default_accuracy, default_losses = cl_one["accuracy_matrix"], cl_one["losses"]
    free_device_memory()
    window_reference = mp_windows(0, 1, device, root, sigterm=False)
    free_device_memory()
    interleaved = torch.cat([torch.arange(r, 16, MP_WORLD) for r in range(MP_WORLD)])
    reordered = mp_windows(0, 1, device, root, sigterm=False, rows=interleaved)
    free_device_memory()
    spread = {"metric_rel": {k: max(abs(a[k] - b[k]) / abs(b[k]) for a, b in zip(reordered["metrics"],
                                                                                window_reference["metrics"]))
                             for k in window_reference["metrics"][0]},
              "params": param_distance(reordered["trainable"], window_reference["trainable"],
                                       window_reference["before"], device=device)}
    del reordered
    one = mp_pretrain(root, 1, device)
    free_device_memory()
    start = time.perf_counter()
    ranks = run_ranks(root, "all", MP_BACKEND, [MP_DEVICE] * MP_WORLD)
    wall = time.perf_counter() - start
    name = "multiprocess"
    if not all(r["reduce_sum"] == [3.0, 20.0] for r in ranks):
        raise AssertionError(f"{name}: process_reduce_sum gave {[r['reduce_sum'] for r in ranks]}")
    window = _window_check(name, ranks, window_reference)
    window["one_process_spread"] = spread
    window["params_vs_one_process"] = param_distance(
        load_task_checkpoint(os.path.join(root, "window_trainable.safetensors")), window_reference.pop("trainable"),
        window_reference.pop("before"), 2.02 * len(window["metrics"]) * train_config().learning_rate, device)
    sigterm = [r["window"]["sigterm"] for r in ranks]
    if len({s["stopped_after_update"] for s in sigterm}) != 1 or [s["signal_here"] for s in sigterm] != [False, True]:
        raise AssertionError(f"{name}: SIGTERM to rank 1 alone: {sigterm}")
    cl = [r["cl"] for r in ranks]
    if any(c["accuracy_matrix"] != cl[0]["accuracy_matrix"] for c in cl):
        raise AssertionError(f"{name}: the ranks' accuracy matrices differ: {[c['accuracy_matrix'] for c in cl]}")
    cl_loss_err = _check_cl_runs(name, cl, default_losses)
    primed = [sum(c["images_primed"][i] for c in cl) for i in range(3)]
    if primed != [32, 96, 0] or [sum(c["teacher_cache"][0]["primed"] for c in cl)] != [32]:
        raise AssertionError(f"{name}: primed images {primed} and teacher states "
                             f"{[c['teacher_cache'] for c in cl]} over the ranks")
    pre = [r["pretrain"] for r in ranks]
    if not all(p["ranks_equal"] for p in pre):
        raise AssertionError(f"{name}: the ranks' parameters differ after the pretraining update")
    loss_err = max(abs(g - w) / abs(w) for (_, g), (_, w) in zip(pre[0]["loss"], one["loss"]))
    if len(pre[0]["loss"]) != 2 or loss_err > MP_METRIC_RTOL:
        raise AssertionError(f"{name}: the pretraining loss against one process's, relative {loss_err}")
    from mafed_tpu_torch.pretrain.trainer import PretrainConfig

    want = load_task_checkpoint(os.path.join(one["out"], "checkpoint-final", "model.safetensors"))
    pretrain_params = param_distance(
        load_task_checkpoint(os.path.join(pre[0]["out"], "checkpoint-final", "model.safetensors")),
        {k: want[k] for k in one["before"]}, one["before"], 2.02 * PretrainConfig().learning_rate,  # 1 update at lr > 0
        device)
    del want
    acc = np.asarray(cl[0]["accuracy_matrix"])
    launches = _sum_launches([r["window"]["launches"] for r in ranks] + [r["window"]["sigterm_launches"] for r in ranks]
                             + [run for c in cl for run in c["launches"].values()] + [p["launches"] for p in pre])
    emit({"phase": name, "card": smi, "backend": ranks[0]["backend"], "device": MP_DEVICE, "ranks": MP_WORLD,
          "note": "two ranks share one card over gloo: a check of correctness, no measure of scaling",
          "reduce_sum": [r["reduce_sum"] for r in ranks], "window": window,
          "sigterm": sigterm,
          "layers": {"windows": MP_LAYERS, "cl": cl_one["layers"], "of": 24},
          "cl": {"switches": MP_CL_SWITCHES, "accuracy_matrix": cl[0]["accuracy_matrix"],
                 "one_process_accuracy_matrix": default_accuracy, "one_process_seconds": cl_one["seconds"],
                 "difference": (acc - np.asarray(default_accuracy)).tolist(), "bwt": cl[0]["bwt"],
                 "resumed_bit_equal": True, "preempted_bundle": cl[0]["bundle"],
                 "images_primed_each_rank": [c["images_primed"] for c in cl],
                 "teacher_states_primed_each_rank": [c["teacher_cache"][0]["primed"] for c in cl],
                 "steps": cl[0]["steps"], "losses": cl[0]["losses"], "one_process_losses": default_losses,
                 "loss_rel_err_vs_one_process": cl_loss_err, "loss_rtol": MP_METRIC_RTOL,
                 "seconds_each_rank": [c["seconds"] for c in cl],
                 "stage_seconds_rank0": cl[0]["stage_seconds"]},
          "pretrain": {"global_batch": MP_PRETRAIN_GLOBAL, "updates": 2,
                       "cut": "global 64, not 128: two ranks on one card",
                       "loss_two_ranks": pre[0]["loss"], "loss_one_process": one["loss"], "loss_rel_err": loss_err,
                       "params_vs_one_process": pretrain_params,
                       "seconds_two_ranks": [p["seconds"] for p in pre], "seconds_one_process": one["seconds"],
                       "peak_memory_gb_each_rank": [p["peak_memory_gb"] for p in pre]},
          "seconds": wall, "launches": launches})
    if torch.cuda.device_count() >= 2:
        nccl = run_ranks(root, "windows", "nccl", ["cuda"] * 2)
        emit({"phase": "multiprocess_nccl", "run": True, "cards": torch.cuda.device_count(),
              "window": _window_check("multiprocess_nccl", nccl, window_reference)})
        launches = _sum_launches([launches] + [r["window"]["launches"] for r in nccl])
    else:
        emit({"phase": "multiprocess_nccl", "run": False, "cards": torch.cuda.device_count()})
    return _sum_launches([launches, window_reference["launches"], one["launches"], cl_one["launches"]]), one, cl_one


# --- phase tensor_parallel: the (data, model) grid of core/mesh.py --------------------------------------------

# Ranks of this script on the one card over gloo, as in phase multiprocess: a check of
# correctness, not a measure of scaling. The 1B windows and pretraining on a model group of
# two ranks (D = 1: each rank all the rows, half the heads); the CL sequence on a 2 x 2 grid.
TP_WINDOW_MESH, TP_CL_MESH, TP_PRETRAIN_MESH = (1, 2), (2, 2), (1, 2)


def _windows_1b(rank: int, device: str, tp) -> tuple:
    """Phase window_1b's three 1B MAFED windows (its seeded weights and rows)
    on this rank's shard of the model (`tp`, its model group, or None), its
    rows split over the data group. Returns (the trainable parameters before,
    on the host, of the whole model (tp None: the reference) or None, the
    model, the result: metrics, ms, launches, peak GB)."""
    from mafed_tpu_torch.core import dist as D
    from mafed_tpu_torch.models.tensor_parallel import shard_model_

    cfg = model_config_for_preset("1b", num_hidden_layers=TP_WINDOW_LAYERS)
    n_ce, b, text_len, windows = 3, 16, 80, 3
    model = shard_model_(init_model(cfg, seed=0, device=device), tp)
    D.broadcast_model_(model)
    step, state, teacher, ce, distill, lang = window_setup(
        cfg, model, n_ce, b, text_len, torch.Generator().manual_seed(2), device)
    rows = slice(D.data_index(), b, D.data_size())
    ce, distill = {k: v[:, rows] for k, v in ce.items()}, {k: v[rows] for k, v in distill.items()}
    before = None if tp is not None else {k: p.detach().cpu().clone() for k, p in trainable_parameters(model).items()}
    cuda = torch.device(device).type == "cuda"
    _sync(device)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    A.reset_launches()
    times, history = [], []
    for _ in range(windows):
        start = time.perf_counter()
        state, m = step(state, teacher, ce, distill, lang)
        _sync(device)
        times.append((time.perf_counter() - start) * 1e3)
        history.append({k: float(m[k]) for k in ("loss", "ce_loss", "distill_loss", "grad_norm")})
    launches = launches_by_dim()
    expected = window_launches(cfg, windows)
    if cuda and launches != expected:
        raise AssertionError(f"tensor_parallel rank {rank}: window launches {launches}, expected {expected}")
    return before, model, {"window_ms": times, "ms_per_window": sum(times[1:]) / (windows - 1),
                           "metrics": history, "launches": launches,
                           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9 if cuda else None}


def tp_windows(rank: int, world: int, device: str, root: str, mesh) -> dict:
    """Under `mesh` (a data axis of 1), rank 0 first runs the 1B windows as
    one process on the whole model, alone in its data group, while the other
    ranks wait (the reference: its metrics, ms, peak GB, and its parameters
    before and after, kept on the host); then every rank runs them on its
    shard, and rank 0 holds the gathered parameters against the reference's
    (no file: the card's machine limits what a command writes)."""
    from mafed_tpu_torch.core import dist as D
    from mafed_tpu_torch.core.mesh import gather_state_dict, make_mesh

    grid = make_mesh(mesh)
    if grid.shape[0] != 1:
        raise ValueError(f"tensor_parallel windows: the reference needs a data axis of 1, not {grid.shape}")
    tp = grid.model if grid.shape[1] > 1 else None
    out, start = {}, time.perf_counter()
    if rank == 0:
        before, model, out["reference"] = _windows_1b(rank, device, None)
        want = {k: p.detach().cpu().clone() for k, p in trainable_parameters(model).items()}
        del model
        free_device_memory()
    D.barrier("tp_reference_done")
    seconds = {"reference": time.perf_counter() - start}
    _, model, result = _windows_1b(rank, device, tp)
    trainable = trainable_parameters(model)
    out.update(result, local_heads=trainable["gpt_neox.layers.0.attention.query_key_value.weight"].shape[0]
               // (3 * model.cfg.head_dim), ranks_equal=equal_on_every_rank(replicated_parameters(model)))
    full = gather_state_dict({k: p.detach() for k, p in trainable.items()}, tp)
    if rank == 0:
        out["params_vs_one_process"] = param_distance(
            full, want, before, 2.02 * len(result["metrics"]) * train_config().learning_rate, device)
    out["seconds"] = {**seconds, "sharded_and_checks": time.perf_counter() - start - seconds["reference"]}
    return out


def tp_worker(rank: int, world: int, device: str, root: str, mode: str) -> dict:
    """One rank of phase tensor_parallel. MODE "tp_windows": the 1B windows
    under TP_WINDOW_MESH (two ranks, over gloo or NCCL); "tp_pair": those,
    then pretraining under TP_PRETRAIN_MESH, the same grid, in the same
    processes; "tp_cl": the CL runs under TP_CL_MESH (four ranks)."""
    if mode in ("tp_windows", "tp_pair"):
        out = {"window": tp_windows(rank, world, device, root, TP_WINDOW_MESH)}
        if mode == "tp_pair":
            free_device_memory()
            out["pretrain"] = mp_pretrain(root, world, device, TP_PRETRAIN_MESH)
        return out
    if mode == "tp_cl":
        return {"cl": cl_runs(rank, device, root, "tp_cl", ["--mesh_shape", *map(str, TP_CL_MESH)], "sigterm",
                              check_best=True)}
    raise ValueError(mode)


def phase_tensor_parallel(smi: str, default_accuracy, default_losses, pretrain_one: dict, root: str,
                          device: str = "cuda") -> dict:
    """Tensor parallelism at full width (cut in depth: TP_WINDOW_LAYERS,
    MP_LAYERS), ranks of this script on the one card over gloo (MP_BACKEND,
    MP_DEVICE): the 1B windows on two ranks under TP_WINDOW_MESH against one
    process (rank 0 alone, first); the CL sequence on four ranks under
    TP_CL_MESH against phase multiprocess's one process (`default_accuracy`,
    `default_losses`: cl_reference), with the SIGTERM and the resume;
    pretraining on two ranks under TP_PRETRAIN_MESH against phase
    multiprocess's one process (`pretrain_one`). Reads phase multiprocess's
    data under `root`. Then the NCCL windows, on two cards only. Returns the
    launches of every rank and of the reference."""
    name = "tensor_parallel"
    start = time.perf_counter()
    world_w, world_cl = math.prod(TP_WINDOW_MESH), math.prod(TP_CL_MESH)
    if TP_PRETRAIN_MESH != TP_WINDOW_MESH:
        raise ValueError("tensor_parallel: the windows and pretraining share their ranks, and so their grid")
    ranks_w = run_ranks(root, "tp_pair", MP_BACKEND, [MP_DEVICE] * world_w)
    reference = ranks_w[0]["window"].pop("reference")
    window = _window_check(name, ranks_w, reference)
    window.update(params_vs_one_process=ranks_w[0]["window"]["params_vs_one_process"],
                  seconds_rank0=ranks_w[0]["window"]["seconds"],
                  local_heads=[r["window"]["local_heads"] for r in ranks_w],
                  peak_memory_gb_each_rank=[r["window"]["peak_memory_gb"] for r in ranks_w],
                  peak_memory_gb_one_process=reference["peak_memory_gb"])
    heads = model_config_for_preset("1b").num_attention_heads // TP_WINDOW_MESH[1]  # 4 of 256 at 1B
    if window["local_heads"] != [heads] * world_w:
        raise AssertionError(f"{name}: local heads {window['local_heads']}, expected {heads}")
    free_device_memory()

    pre = [r["pretrain"] for r in ranks_w]
    parts = {"windows_and_pretrain": time.perf_counter() - start}
    ranks_cl = run_ranks(root, "tp_cl", MP_BACKEND, [MP_DEVICE] * world_cl)
    cl = [r["cl"] for r in ranks_cl]
    if any(c["accuracy_matrix"] != default_accuracy for c in cl):
        raise AssertionError(f"{name}: accuracy matrices {[c['accuracy_matrix'] for c in cl]} against one "
                             f"process's {default_accuracy}")
    cl_loss_err = _check_cl_runs(name, cl, default_losses)
    if not cl[0]["best_checkpoint_equal"]:
        raise AssertionError(f"{name}: the best checkpoint, read by rank 0 alone, differs from the gathered model")
    parts["cl"] = time.perf_counter() - start - parts["windows_and_pretrain"]

    if not all(p["ranks_equal"] for p in pre):
        raise AssertionError(f"{name}: the ranks' replicated parameters differ after pretraining")
    loss_err = max(abs(g - w) / abs(w) for (_, g), (_, w) in zip(pre[0]["loss"], pretrain_one["loss"]))
    if len(pre[0]["loss"]) != 2 or loss_err > TP_PRETRAIN_LOSS_RTOL:
        raise AssertionError(f"{name}: the pretraining loss against one process's, relative {loss_err}")
    from mafed_tpu_torch.pretrain.trainer import PretrainConfig

    want = load_task_checkpoint(os.path.join(pretrain_one["out"], "checkpoint-final", "model.safetensors"))
    pretrain_params = param_distance(
        load_task_checkpoint(os.path.join(pre[0]["out"], "checkpoint-final", "model.safetensors")),
        {k: want[k] for k in pretrain_one["before"]}, pretrain_one["before"], 2.02 * PretrainConfig().learning_rate,
        device)
    del want
    wall = time.perf_counter() - start
    launches = _sum_launches([r["window"]["launches"] for r in ranks_w]
                             + [run for c in cl for run in c["launches"].values()] + [p["launches"] for p in pre])
    emit({"phase": name, "card": smi, "backend": ranks_w[0]["backend"], "device": MP_DEVICE,
          "note": "ranks share one card over gloo: a check of correctness, no measure of scaling",
          "window_1b": {"mesh": TP_WINDOW_MESH, "layers": TP_WINDOW_LAYERS, "of": 16, **window},
          "cl": {"mesh": TP_CL_MESH, "switches": MP_CL_SWITCHES, "accuracy_matrix": cl[0]["accuracy_matrix"],
                 "one_process_accuracy_matrix": default_accuracy, "bwt": cl[0]["bwt"],
                 "best_checkpoint_bit_equal": True, "resumed_bit_equal": True,
                 "sigterm": {"to_rank": 1, "after_update": CL_INTERRUPT_AFTER, "bundle": cl[0]["bundle"],
                             "updates_each_rank": [c["stopped_updates_here"] for c in cl]},
                 "images_primed_each_rank": [c["images_primed"] for c in cl],
                 "teacher_states_primed_each_rank": [c["teacher_cache"][0]["primed"] for c in cl],
                 "steps": cl[0]["steps"], "losses": cl[0]["losses"], "one_process_losses": default_losses,
                 "loss_rel_err_vs_one_process": cl_loss_err, "loss_rtol": MP_METRIC_RTOL,
                 "seconds_each_rank": [c["seconds"] for c in cl], "stage_seconds_rank0": cl[0]["stage_seconds"]},
          "pretrain": {"mesh": TP_PRETRAIN_MESH, "global_batch": MP_PRETRAIN_GLOBAL, "updates": 2,
                       "loss_ranks": pre[0]["loss"], "loss_one_process": pretrain_one["loss"],
                       "loss_rel_err": loss_err, "loss_rtol": TP_PRETRAIN_LOSS_RTOL,
                       "params_vs_one_process": pretrain_params,
                       "seconds_ranks": [p["seconds"] for p in pre], "seconds_one_process": pretrain_one["seconds"],
                       "peak_memory_gb_each_rank": [p["peak_memory_gb"] for p in pre]},
          "seconds": wall, "seconds_parts": parts, "launches": launches})
    if torch.cuda.device_count() >= world_w:
        nccl = run_ranks(root, "tp_windows", "nccl", ["cuda"] * world_w)
        emit({"phase": "tensor_parallel_nccl", "run": True, "cards": torch.cuda.device_count(),
              "window": _window_check("tensor_parallel_nccl", nccl, reference)})
        launches = _sum_launches([launches] + [r["window"]["launches"] for r in nccl])
    else:
        emit({"phase": "tensor_parallel_nccl", "run": False, "cards": torch.cuda.device_count()})
    return _sum_launches([launches, reference["launches"]])


def free_device_memory() -> None:
    """Drop what earlier phases left cached on the card (their models are out of scope)."""
    gc.collect()
    torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    smi = phase_device()
    phase_build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    errs, timing, errs_f32, timing_f32 = phase_kernels(gen)
    for head_dim in TINY_DECODERS:
        phase_reference(head_dim)
    phase_reference_steps()
    phase_reference_tables()
    phase_image_engine(smi)  # host only; the pretrain phases decode through the engine it built
    # pretraining first: its update at batch 128 peaks at ~75 of the card's 80 GB, best met before
    # the other phases have fragmented the allocator's pool
    free_device_memory()
    by_path = {}
    with tempfile.TemporaryDirectory(prefix="pretrain_") as root:
        pretrain = phase_pretrain(smi, root)
        by_path["pretrain"] = pretrain.pop("launches")
        shutil.rmtree(os.path.join(pretrain["out"], "checkpoint-4"))  # the later phases read 2 and final
        del pretrain["trainer"].model
        free_device_memory()
        by_path["pretrain_resume"] = phase_pretrain_resume(smi, pretrain)
        free_device_memory()
        by_path["pretrain_to_cl"] = phase_pretrain_to_cl(smi, pretrain, root)
        del pretrain
    free_device_memory()
    window = phase_window(smi, "410m", "window")
    by_path.update({"window": window["launches"], "decode": phase_decode(smi, "410m", "decode"),
                    **phase_train_steps(smi)})
    free_device_memory()
    # the float32 kernels' paths: by_path keeps the bf16 launches by head_dim, by_path_f32 the f32 ones
    window_f32 = phase_window(smi, "410m", "window_f32", plain_check=True, compute_dtype="float32",
                              reference=window["metrics"])
    by_path_f32 = {"window_f32": window_f32["launches_by_dtype"]["float32"]}
    free_device_memory()
    by_path["remat_policies"] = phase_remat_policies(smi)
    free_device_memory()
    by_path["clip_eval"] = phase_clip_eval(smi, gen)
    # VL-Pythia-1B, with the 410M models and their caches gone
    # then VL-Pythia-1.4B (heads of 128) and the decoder at GPT-NeoX-20B's width (heads of 96)
    for path, run in (("window_1b", lambda: phase_window(smi, "1b", "window_1b")["launches"]),
                      ("ce_window_1b", lambda: phase_ce_window(smi, "1b", "ce_window_1b")),
                      ("decode_1b", lambda: phase_decode(smi, "1b", "decode_1b")),
                      ("window_1_4b", lambda: phase_window(smi, "1.4b", "window_1_4b", plain_check=True)["launches"]),
                      ("ce_window_1_4b", lambda: phase_ce_window(smi, "1.4b", "ce_window_1_4b")),
                      ("decode_1_4b", lambda: phase_decode(smi, "1.4b", "decode_1_4b")),
                      ("window_d96",
                       lambda: phase_window(smi, "neox20b_4l", "window_d96", plain_check=True)["launches"]),
                      # the wide kernels: 1B's decoder as 4 heads of 512, the 20B-width cut as 16 of 384
                      ("window_d512",
                       lambda: phase_window(smi, "1b_d512", "window_d512", plain_check=True)["launches"]),
                      ("decode_d512", lambda: phase_decode(smi, "1b_d512", "decode_d512")),
                      ("window_d384",
                       lambda: phase_window(smi, "neox20b_4l_d384", "window_d384", plain_check=True)["launches"])):
        free_device_memory()
        by_path[path] = run()
    free_device_memory()
    streaming = phase_cl_sequence(smi)
    by_path["cl_sequence"] = streaming["launches"]
    free_device_memory()
    # the same sequence at --compute_dtype float32: its windows through the f32 kernels, eval and the
    # tower (all at head_dim 64) through the bf16 ones
    run_f32 = phase_cl_sequence(smi, compute_dtype="float32", phase="cl_sequence_f32")
    by_path["cl_sequence_f32"] = at_head_dim(64, run_f32["launches_by_dtype"]["bfloat16"])
    by_path_f32["cl_sequence_f32"] = run_f32["launches_by_dtype"]["float32"]
    del run_f32
    free_device_memory()
    with tempfile.TemporaryDirectory(prefix="cl_default_") as root:
        default = phase_cl_sequence_default(smi, streaming, root)
        by_path["cl_sequence_default"] = default["launches"]
        del streaming
        free_device_memory()
        by_path["cka_sweep"] = phase_cka_sweep(smi, default)
    free_device_memory()
    by_path["cl_resume"] = phase_cl_resume(smi, default)
    free_device_memory()
    with tempfile.TemporaryDirectory(prefix="multiprocess_") as root:
        by_path["multiprocess"], pretrain_one, cl_one = phase_multiprocess(smi, root)
        free_device_memory()
        by_path["tensor_parallel"] = phase_tensor_parallel(
            smi, cl_one["accuracy_matrix"], cl_one["losses"], pretrain_one, root)
        del pretrain_one, cl_one
    free_device_memory()
    by_path["profile"] = phase_profile(smi)
    # one entry per kernel and head_dim that launched: times at its head_dim's CE shape (410M: 64, the
    # 20B-width decoder: 96, 1.4B: 128, 1B: 256; the wide kernels at 1B as heads of 512 and the 20B
    # width as heads of 384)
    tp_shape = {64: "tp_410m", 256: "tp_1b"}
    launched = _sum_launches(by_path.values())
    idle = [f"{name}<{d}>" for d in (*build.HEAD_DIMS, 384, 512) for name in KERNELS
            if not launched.get(d, {}).get(name)]
    idle += [f"{name}_f32" for name in KERNELS if not sum(path[name] for path in by_path_f32.values())]
    if idle:
        raise AssertionError(f"kernels that the main path never launched: {idle}")
    kernels = [
        {"name": f"{name}<{d}>", "head_dim": d, "route": "cuda", "source": "mafed_tpu_torch/csrc/flash_attn.cu",
         "instantiation": build.route(name, "bfloat16", d).instantiation,
         "replaces": replaces,
         "design": (SM90_FWD_SPLIT[d] if name == "flash_fwd" and d in SM90_FWD_SPLIT else
                    SM90_FWD_WIDE if name == "flash_fwd" and build.wide_head_dim(d) else
                    SM90_DKV_CTA[d] if name == "flash_bwd_dkv" and d in SM90_DKV_CTA else design),
         "launches": launched[d][name],
         "launches_by_path": {p: path.get(d, {}).get(name, 0) for p, path in by_path.items()},
         "max_abs_err": errs[name, d], "ms": timing[d]["ms"][name], "plain_ms": timing[d]["plain_ms"][name],
         "bound_ms": timing[d]["bound_ms"][name], "bound_by": timing[d]["bound_by"][name],
         "library_ms": timing[d]["library_ms"][name], "library_covers": LIBRARY_COVERS[name],
         **({"at_pretrain_shape": {key: timing["pretrain"][key][name] for key in
                                   ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}} if d == 64 else {}),
         **({"at_tp_rank_shape": {key: timing[tp_shape[d]][key][name] for key in
                                  ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}} if d in tp_shape else {})}
        for name, (replaces, design) in KERNELS.items() for d in launched
    ]
    # the float32 kernels: one instantiation each, every head_dim at run time; launched on the main
    # path at head_dim 64 (410M), timed at every head_dim's CE shape, the entry's own numbers at 64's
    timed = ("ms", "plain_ms", "bound_ms", "bound_by", "bound_ffma_ms", "library_ms")
    kernels += [
        {"name": f"{name}_f32", "dtype": "float32", "head_dim": 64, "route": "cuda",
         "source": "mafed_tpu_torch/csrc/flash_attn_f32.cu",
         "instantiation": build.route(name, "float32", 64).instantiation, "replaces": replaces,
         "design": SM90_F32[name],
         "launches": sum(path[name] for path in by_path_f32.values()),
         "launches_by_path": {p: path[name] for p, path in by_path_f32.items()},
         "max_abs_err": max(e for (k, _), e in errs_f32.items() if k == name),
         **{key: timing_f32[64][key][name] for key in timed},
         "library_backend": timing_f32[64]["library_backend"], "library_covers": LIBRARY_COVERS[name],
         "at_head_dims": {d: {"max_abs_err": errs_f32[name, d], **{key: t[key][name] for key in timed}}
                          for d, t in timing_f32.items()}}
        for name, (replaces, _) in KERNELS.items()
    ]
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(mp_worker(sys.argv[2:]) if sys.argv[1:2] == ["--mp-worker"] else main())
