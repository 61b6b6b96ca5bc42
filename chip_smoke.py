"""Smoke run of the PyTorch/CUDA port (mafed_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each printing one JSON line:
  1. device: the card's name and power limit (nvidia-smi), torch and CUDA versions;
  2. build: compiles csrc/flash_attn.cu with nvcc for sm_90a and prints each
     kernel's registers and spill bytes (-Xptxas -v) and its HGMMA and
     UTMALDG instruction counts (cuobjdump -sass, where the toolkit has it);
     all three are TMA + wgmma kernels, and none may spill or lack either;
  3. kernels: the three flash kernels against their plain PyTorch versions on
     the card, in bf16, at the shapes of the 410M window and CE window (and
     EVA-02 shapes, a 129-token case across the tile edge and a small
     unaligned case with fully-masked rows), and their times at the CE shape beside the plain
     versions, the bound and torch.nn.functional.scaled_dot_product_attention
     (a yardstick only: its forward for the forward kernel, its whole
     backward, which also computes dq, for each backward kernel);
  4. reference: one window of a tiny model on the card (CUDA kernels) against
     the same window on the CPU (plain versions), and that model's tower
     features and KV-cache prefill logits (head_dim-64 tower and decoder);
     then its CE window, EWC window, train step, distill step, Fisher
     accumulator and adaptive-weight sums, card against CPU;
  5. window: three fused MAFED windows of VL-Pythia-410M at full width and
     depth (random seeded weights, cached-patch shapes of the bench), with the
     kernel launch counts of that run;
  6. decode: greedy KV-cache decode of VL-Pythia-410M + EVA-02-L at full width
     and depth (bf16 weights from a seed; batch 32, text 64 with 16 left-padded
     positions, 10 new tokens), from uint8 pixels through the tower and from
     the tower's cached patch features, each timed over 6 batches after a
     warm-up with batch i+1 dispatched before batch i is read, with the kernel
     launch counts of each route; the emitted tokens checked against a
     no-cache forward; then validate_vqa over 3 synthetic batches;
  7. train_steps: the other training paths of VL-Pythia-410M at full width and
     depth, each from the same seeded weights and microbatches of 16 (text 80,
     20 left-padded positions, an 8-token answer, uint8 pixels and the tower's
     features of them): CE and EWC windows of 4 microbatches (the EWC
     importances from the Fisher accumulator over 2 batches), the
     per-microbatch cadence under MultiSteps(4) (4 train steps; 3 train steps
     and a distill step), the MAFED window fused, unfused and from pixels, and
     the adaptive-weight sums; each path's times, launches and checks, and two
     cross-path checks of the first losses.
Then the kernel summary line, the nvidia-smi line, and as the last line
{"ok": true, "device": {...}}. Any failure raises and exits non-zero; without
a CUDA device, or without the package beside it, the script exits non-zero
before printing anything.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from mafed_tpu_torch.core.config import ModelConfig, TrainConfig, VisionConfig, model_config_for_preset
from mafed_tpu_torch.data.images import make_normalizer, prep_pixels, synthetic_image
from mafed_tpu_torch.data.tokenizer import ByteTokenizer
from mafed_tpu_torch.evaluation.decode import make_greedy_decoder
from mafed_tpu_torch.evaluation.validate import validate_vqa
from mafed_tpu_torch.kernels import attention as A
from mafed_tpu_torch.kernels import build
from mafed_tpu_torch.models import gpt_neox
from mafed_tpu_torch.models import vl_pythia as V
from mafed_tpu_torch.models.vl_pythia import init_model
from mafed_tpu_torch.optim.optimizer import MultiSteps, build_optimizer, set_schedule
from mafed_tpu_torch.training.flops import (
    ce_example_flops, framework_decode_flops_per_example, framework_window_flops, mfu,
)
from mafed_tpu_torch.training.step import (
    distillation_layers, make_adaptive_weights_fn, make_ce_window_step, make_distill_step, make_ewc_fisher_fn,
    make_mafed_window_step, make_train_step,
)
from mafed_tpu_torch.training.train_state import TrainState, make_teacher, trainable_parameters

# Tolerances of the kernel checks (bf16): the tiled kernels round p to bf16
# relative to a running row maximum, the dense plain versions relative to the
# final one, so single elements differ by a few bf16 ulps.
ATOL, RTOL = 2e-2, 2e-2
LSE_ATOL = 1e-4  # lse is f32 in both

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
BF16_FLOPS_PER_S = 989e12  # H100 SXM dense bf16

SM90 = "sm90 tma+wgmma"
# name (its CUDA kernel is name + "_kernel"): (the TPU kernel it replaces, its design)
KERNELS = {
    "flash_fwd": ("mafed_tpu/kernels/attention.py:81", SM90),
    "flash_bwd_dkv": ("mafed_tpu/kernels/attention.py:230", SM90),
    "flash_bwd_dq": ("mafed_tpu/kernels/attention.py:294", SM90),
}


def emit(obj) -> None:
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
    emit({"phase": "build", "seconds": seconds, "ptxas": resources, "sass": sass, "warnings": warnings})
    for name in KERNELS:
        kernel = f"{name}_kernel"
        res = resources.get(kernel, {})
        if res.get("spill_store_bytes") != 0 or res.get("spill_load_bytes") != 0:
            raise AssertionError(f"{kernel}: spills or no ptxas report: {res}")
        if sass is not None and not (sass[kernel]["HGMMA"] and sass[kernel]["UTMALDG"]):
            raise AssertionError(f"{kernel}: no HGMMA or UTMALDG in its SASS: {sass[kernel]}")


def _qkv(gen, b, h, t, pad, empty_sample):
    q, k, v, do = (torch.randn(b, h, t, 64, generator=gen, device="cuda").to(torch.bfloat16) for _ in range(4))
    mask = torch.ones(b, t, dtype=torch.int32, device="cuda")
    if pad is not None:
        mask[:, pad[0]:pad[1]] = 0
    if empty_sample:
        mask[-1] = 0
    return q, k, v, do, (mask if pad is not None or empty_sample else None)


def _err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def phase_kernels(gen):
    # (name, batch, heads, seq, causal, padded key range, all-masked last sample)
    cases = [
        ("ce_410m", 48, 16, 336, True, (256, 276), False),
        ("ce_window_410m", 64, 16, 336, True, (256, 276), False),  # the CE window's 4 x 16 rows
        ("student_410m", 16, 16, 336, True, (256, 276), False),
        ("eva02_noncausal", 16, 16, 257, False, None, False),
        ("eva02_tower_b32", 32, 16, 257, False, None, False),  # the decode's tower
        ("eva02_tower_b64", 64, 16, 257, False, None, False),  # a pixels-route window's 48 + 16 images
        ("decode_prefill_b32", 32, 16, 320, True, (256, 272), False),  # the decode's prefill
        ("causal_129_padded", 8, 4, 129, True, (0, 7), False),
        ("small_unaligned_empty_rows", 3, 2, 77, True, (0, 3), True),
    ]
    errs = {name: 0.0 for name in KERNELS}
    scale = 0.125
    for name, b, h, t, causal, pad, empty in cases:
        q, k, v, do, mask = _qkv(gen, b, h, t, pad, empty)
        o, lse = A.flash_forward(q, k, v, mask, causal, scale)
        o_p, lse_p = A.flash_forward_plain(q, k, v, mask, causal, scale)
        fin = torch.isfinite(lse_p)
        if not torch.equal(torch.isinf(lse), ~fin):
            raise AssertionError(f"{name}: empty rows differ between kernel and plain version")
        torch.testing.assert_close(o.float(), o_p.float(), atol=ATOL, rtol=RTOL)
        torch.testing.assert_close(lse[fin], lse_p[fin], atol=LSE_ATOL, rtol=0)
        delta = (do.float() * o_p.float()).sum(-1)
        dk, dv = A.flash_bwd_dkv(q, k, v, mask, do, lse_p, delta, causal, scale)
        dq = A.flash_bwd_dq(q, k, v, mask, do, lse_p, delta, causal, scale)
        dq_p, dk_p, dv_p = A.flash_backward_plain(q, k, v, mask, o_p, lse_p, do, causal, scale)
        for got, want in ((dq, dq_p), (dk, dk_p), (dv, dv_p)):
            torch.testing.assert_close(got.float(), want.float(), atol=ATOL, rtol=RTOL)
        torch.cuda.synchronize()
        case_err = {
            "flash_fwd": max(_err(o, o_p), (lse[fin] - lse_p[fin]).abs().max().item()),
            "flash_bwd_dkv": max(_err(dk, dk_p), _err(dv, dv_p)),
            "flash_bwd_dq": _err(dq, dq_p),
        }
        for kname, e in case_err.items():
            errs[kname] = max(errs[kname], e)
        emit({"phase": "kernels", "case": name, "shape": [b, h, t, 64], "causal": causal,
              "max_abs_err": case_err, "atol": ATOL, "rtol": RTOL})

    # times at the CE shape of the 410M window
    b, h, t, d = 48, 16, 336, 64
    q, k, v, do, mask = _qkv(gen, b, h, t, (256, 276), False)
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

    # yardstick, never called by the port: PyTorch's fused attention on the same inputs
    keep = torch.ones(t, t, dtype=torch.bool, device="cuda").tril()[None, None] & (mask > 0)[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    sdpa_fwd = time_ms(lambda: sdpa(q, k, v, attn_mask=keep, scale=scale))
    qg, kg, vg = (x.detach().requires_grad_(True) for x in (q, k, v))
    out = sdpa(qg, kg, vg, attn_mask=keep, scale=scale)
    sdpa_bwd = time_ms(lambda: torch.autograd.grad(out, (qg, kg, vg), do, retain_graph=True))

    # least time for the same work: each input read once, each output written
    # once; products counted over the (query, key) pairs this mask keeps
    pairs = h * int((torch.ones(t, t, device="cuda").tril()[None] * (mask > 0)[:, None, :]).sum().item())
    act, row, msk = b * h * t * d * 2, b * h * t * 4, b * t * 4
    work = {
        "flash_fwd": (3 * act + msk + act + row, 4 * d * pairs),
        "flash_bwd_dkv": (4 * act + 2 * row + msk + 2 * act, 8 * d * pairs),
        "flash_bwd_dq": (4 * act + 2 * row + msk + act, 6 * d * pairs),
    }
    bounds = {}
    for kname, (nbytes, flops) in work.items():
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS_PER_S * 1e3
        bounds[kname] = (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")
    emit({"phase": "kernels", "case": "timing_ce_410m", "ms": ms, "plain_ms": plain_ms,
          "sdpa_fwd_ms": sdpa_fwd, "sdpa_bwd_ms": sdpa_bwd,
          "bound_ms": {n: v[0] for n, v in bounds.items()}, "kept_pairs": pairs})
    for case, b2, t2, causal, pad in (("timing_decode_tower", 32, 257, False, None),
                                      ("timing_decode_prefill", 32, 320, True, (256, 272)),
                                      ("timing_ce_window", 64, 336, True, (256, 276)),
                                      ("timing_window_tower_b64", 64, 257, False, None)):
        emit({"phase": "kernels", "case": case, **_fwd_timing(gen, b2, h, t2, causal, pad, scale)})
    library = {"flash_fwd": (sdpa_fwd, "o"), "flash_bwd_dkv": (sdpa_bwd, "dq+dk+dv"),
               "flash_bwd_dq": (sdpa_bwd, "dq+dk+dv")}
    return errs, ms, plain_ms, bounds, library


def _fwd_timing(gen, b, h, t, causal, pad, scale) -> dict:
    """The forward kernel at one shape of the decode or the training paths:
    its time beside the plain version's, SDPA's forward and its bound (as at
    the CE shape)."""
    q, k, v, _, mask = _qkv(gen, b, h, t, pad, False)
    keep = torch.ones(t, t, dtype=torch.bool, device="cuda")
    if causal:
        keep = keep.tril()
    keep = keep[None, None] & ((mask > 0)[:, None, None, :] if mask is not None else True)
    pairs = h * int(keep.expand(b, 1, t, t).sum().item())
    act, row = b * h * t * 64 * 2, b * h * t * 4
    nbytes = 4 * act + row + (b * t * 4 if mask is not None else 0)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, 4 * 64 * pairs / BF16_FLOPS_PER_S * 1e3
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return {"shape": [b, h, t, 64], "causal": causal,
            "ms": time_ms(lambda: A.flash_forward(q, k, v, mask, causal, scale)),
            "plain_ms": time_ms(lambda: A.flash_forward_plain(q, k, v, mask, causal, scale)),
            "sdpa_fwd_ms": time_ms(lambda: sdpa(q, k, v, attn_mask=keep, scale=scale)),
            "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "kept_pairs": pairs}


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


def train_config() -> TrainConfig:
    """The bench's training settings: AdamW with a bf16 first moment, balanced
    modality weights, discounted layers (gamma 0.5)."""
    return TrainConfig(
        optim="adamw", weight_decay=0.01, adam_mu_dtype="bfloat16",
        replay_coeff=1.0, distillation_coeff=1.0,
        distillation_modality_weighing_strategy="balanced",
        distillation_layer_weighing_strategy="discounted", distillation_layer_discount=0.5,
    )


def stack(batches):
    """[n_mb, B, ...] stacks of a list of microbatches."""
    return {k: torch.stack([mb[k] for mb in batches]) for k in batches[0]}


def window_setup(cfg, model, n_ce, b, text_len, gen, device, fuse_ce_batch=True):
    train_cfg = train_config()
    teacher = make_teacher(model)
    trainable = trainable_parameters(model)
    opt = build_optimizer(train_cfg, trainable)
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


def tiny_config() -> ModelConfig:
    """A tiny VL-Pythia whose decoder and tower both have heads of 64 (16
    patches + CLS), so every attention call takes the flash kernels."""
    return ModelConfig(vocab_size=512, hidden_size=128, num_hidden_layers=3, num_attention_heads=2,
                       intermediate_size=256, vision=VisionConfig(img_size=56, embed_dim=128, depth=2, num_heads=2))


def phase_reference() -> None:
    """One window of a tiny model (head_dim 64) on the card against the same
    window on the CPU, both bf16: losses within rtol 3e-2 (bf16 matmul
    outputs and the tiled softmax round differently on the two devices). The
    same model with a head_dim-64 tower (16 patches + CLS): its tower features
    and the KV-cache prefill's last-position logits on the card against the
    CPU, relative norm error within 3e-2."""
    cfg = tiny_config()
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
    emit({"phase": "reference", "cpu": metrics["cpu"], "cuda": metrics["cuda"], "rtol": 3e-2,
          "eval_rel_err": errs})


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


def phase_window(smi: str):
    cfg = model_config_for_preset("410m")
    n_ce, b, text_len, windows = 3, 16, 80, 3
    model = init_model(cfg, seed=0, device="cuda")
    step, state, teacher, ce, distill, lang = window_setup(
        cfg, model, n_ce, b, text_len, torch.Generator().manual_seed(2), "cuda")
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
    launches = dict(A.LAUNCHES)

    for h in history:
        bad = [k for k, v in h.items() if not torch.isfinite(torch.tensor(v))]
        if bad:
            raise AssertionError(f"non-finite window metrics: {bad} in {h}")
    unchanged = [n for n, p in trainable_parameters(model).items() if torch.equal(p, before[n])]
    if unchanged:
        raise AssertionError(f"parameters that no update moved: {unchanged[:5]} ({len(unchanged)})")
    # per window: fwd in every layer of the CE (24), student (24) and teacher
    # (22, early exit) passes, plus the per-layer recompute of the 48
    # differentiated layers in backward; dK/dV and dQ once per differentiated layer
    layers = cfg.num_hidden_layers
    per_window = {"flash_fwd": 2 * layers + (layers - 2) + 2 * layers,
                  "flash_bwd_dkv": 2 * layers, "flash_bwd_dq": 2 * layers}
    expected = {k: windows * v for k, v in per_window.items()}
    if launches != expected:
        raise AssertionError(f"kernel launches {launches}, expected {expected}")

    ms_window = sum(times[1:]) / (windows - 1)  # the first window pays cuBLAS and allocator warm-up
    examples = (n_ce + 1) * b
    ex_per_s = examples / (ms_window / 1e3)
    flops = framework_window_flops(cfg, text_len, n_ce, b) / examples
    emit({"phase": "window", "card": smi, "preset": "410m", "layers": layers, "hidden": cfg.hidden_size,
          "n_ce": n_ce, "batch": b, "text_len": text_len, "window_ms": times,
          "ms_per_window": ms_window, "examples_per_s": ex_per_s, "mfu": mfu(ex_per_s, flops),
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
          "metrics": history, "launches": launches, "expected_launches": expected})
    return launches


def _kernels(fwd: int, bwd: int) -> dict:
    return {"flash_fwd": fwd, "flash_bwd_dkv": bwd, "flash_bwd_dq": bwd}


def run_path(name, calls, trainable=None, snapshot=None) -> dict:
    """Run one path's calls in order, each a (fn, launches, examples, flops)
    with fn() -> metrics; check finite metrics, the kernel launches and, when
    a snapshot is given, that every trainable tensor moved. Times exclude the
    first call (cuBLAS and allocator warm-up)."""
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
    launches = dict(A.LAUNCHES)
    expected = {k: sum(c[1][k] for c in calls) for k in A.LAUNCHES}
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
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9, "launches": launches,
            "metrics": history}


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

    def call(box, step, *args):
        def fn():
            box[0], m = step(box[0], *args)
            return m
        return fn

    ce_ex = ce_example_flops(cfg, text_len)
    memory_ex = framework_window_flops(cfg, text_len, 0, 1)  # one memory example: student + teacher
    train_call = _kernels(layers, layers)  # no remat: the saved (o, lse) go to the backward kernels
    remat_pass = _kernels(2 * layers, layers)  # a forward, and the layers' recompute in backward
    paths, first = {}, {}

    opt, box = fresh()
    step = make_ce_window_step(cfg, train_cfg, opt)
    paths["ce_window"] = run_path("ce_window", [(call(box, step, stack(mbs)), remat_pass, n_mb * b, n_mb * b * ce_ex)] * 3,
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
        "ewc_window", [(call(box, step, stack(mbs), ewc_state), remat_pass, n_mb * b, n_mb * b * ce_ex)] * 3,
        trainable, snapshot)
    del ewc_state

    opt, box = fresh(every_k=n_mb)
    step = make_train_step(cfg, train_cfg, opt)
    paths["train_step_cadence"] = run_path(
        "train_step_cadence", [(call(box, step, mb), train_call, b, b * ce_ex) for mb in mbs], trainable, snapshot)

    opt, box = fresh(every_k=n_mb)
    step, d_step = make_train_step(cfg, train_cfg, opt), make_distill_step(cfg, train_cfg, opt)
    calls = [(call(box, step, mb), train_call, b, b * ce_ex) for mb in mbs[:n_ce]]
    calls.append((call(box, d_step, teacher, mbs[n_ce], lang), _kernels(layers + deepest, layers), b, b * memory_ex))
    paths["mafed_cadence"] = run_path("mafed_cadence", calls, trainable, snapshot)

    fused_window = _kernels(2 * 2 * layers + deepest, 2 * layers)  # CE and student remat, teacher forward only
    window_ex = framework_window_flops(cfg, text_len, n_ce, b)
    ce_stack, memory = stack(mbs[:n_ce]), mbs[n_ce]
    opt, box = fresh()
    step = make_mafed_window_step(cfg, train_cfg, opt, n_ce=n_ce)
    paths["mafed_fused"] = run_path(
        "mafed_fused", [(call(box, step, teacher, ce_stack, memory, lang), fused_window, n_mb * b, window_ex)] * 2,
        trainable, snapshot)
    opt, box = fresh()
    step = make_mafed_window_step(cfg, train_cfg, opt, n_ce=n_ce, fuse_ce_batch=False)
    unfused = _kernels(n_ce * 2 * layers + 2 * layers + deepest, (n_ce + 1) * layers)
    paths["mafed_unfused"] = run_path(
        "mafed_unfused", [(call(box, step, teacher, ce_stack, memory, lang), unfused, n_mb * b, window_ex)] * 2,
        trainable, snapshot)
    opt, box = fresh()
    step = make_mafed_window_step(cfg, train_cfg, opt, n_ce=n_ce)
    pixels_window = dict(fused_window, flash_fwd=fused_window["flash_fwd"] + vis_depth)  # the tower once
    pixels_ex = framework_window_flops(cfg, text_len, n_ce, b, vision_cached=False)
    paths["mafed_pixels"] = run_path(
        "mafed_pixels", [(call(box, step, teacher, stack(px[:n_ce]), px[n_ce], lang), pixels_window, n_mb * b,
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
    return {p: v["launches"] for p, v in paths.items()}


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


def phase_decode(smi: str):
    """Greedy decode of VL-Pythia-410M + EVA-02-L (bench_eval.py's shapes), uncached and cached routes."""
    cfg = model_config_for_preset("410m")
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
    layers, vis_layers = cfg.num_hidden_layers, cfg.vision.depth
    routes, launches, first = {}, {}, {}
    for route, data, per_batch in (("pixels", host, vis_layers + layers), ("patches", cached, layers)):
        run_decode(decode, model, data[:1])  # warm-up: cuBLAS, the allocator, the kernel library
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        A.reset_launches()
        toks, ms = run_decode(decode, model, data[1:])
        launches[route] = dict(A.LAUNCHES)
        expected = {"flash_fwd": per_batch * n, "flash_bwd_dkv": 0, "flash_bwd_dq": 0}
        if launches[route] != expected:
            raise AssertionError(f"decode ({route}): kernel launches {launches[route]}, expected {expected}")
        if any(t.shape != (b, max_new) or t.dtype != torch.int32 or t.min() < 0 or t.max() >= cfg.vocab_size
               for t in toks):
            raise AssertionError(f"decode ({route}): tokens of shape {toks[0].shape} {toks[0].dtype} or out of the vocabulary")
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
    emit({"phase": "decode", "card": smi, "preset": "410m", "vision": "eva02_large_patch14_224",
          "batch": b, "text_len": text_len, "left_pad": pad, "max_new_tokens": max_new, "timed_batches": n,
          "dtype": "bfloat16", "routes": routes, "cache_invariance": invariance, "validate": val_log})
    return {k: sum(launches[r][k] for r in launches) for k in A.LAUNCHES}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    smi = phase_device()
    phase_build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    errs, ms, plain_ms, bounds, library = phase_kernels(gen)
    phase_reference()
    phase_reference_steps()
    by_path = {"window": phase_window(smi), "decode": phase_decode(smi), **phase_train_steps(smi)}
    kernels = [
        {"name": name, "route": "cuda", "source": "mafed_tpu_torch/csrc/flash_attn.cu", "replaces": replaces,
         "design": design, "launches": sum(path[name] for path in by_path.values()),
         "launches_by_path": {p: path[name] for p, path in by_path.items()},
         "max_abs_err": errs[name], "ms": ms[name],
         "plain_ms": plain_ms[name], "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
         "library_ms": library[name][0], "library_covers": library[name][1]}
        for name, (replaces, design) in KERNELS.items()
    ]
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
