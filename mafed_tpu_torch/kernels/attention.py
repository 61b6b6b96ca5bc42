"""Attention for the H100: hand-written CUDA flash kernels and their plain versions.

Counterpart of mafed_tpu/kernels/attention.py. Layout: q, k, v are
[batch, heads, seq, head_dim].

  * `flash_forward` / `flash_backward` launch the kernels of
    `csrc/flash_attn.cu` (bfloat16 inputs) or `csrc/flash_attn_f32.cu`
    (float32 inputs, a `--compute_dtype float32` run) on CUDA tensors and
    run the dense plain versions (`flash_forward_plain` /
    `flash_backward_plain`) on CPU tensors. A CUDA call the kernels cannot
    take (float16, mixed dtypes, an odd head_dim) raises; there is no
    fallback.
  * `FlashAttention` is the autograd function: its forward saves
    (q, k, v, mask, o, lse) and its backward computes delta = rowsum(do * o)
    and launches the dK/dV and dQ kernels. Inside a layer under a named
    remat policy (`REMAT_STASH`, models/gpt_neox.py) the policy may keep
    (o, lse) from the forward and hand them back to the recompute, which
    then launches no forward.
  * `dot_product_attention` dispatches by shape as the JAX package's does on
    its TPU: a call with `causal_offset` (a KV-cache decode step) and every
    shape that the JAX dispatcher sends to `xla_attention` take the plain
    masked path (`masked_attention`) on every device; every other call the
    flash path: the training window, the EVA-02 tower (non-causal, unmasked)
    and the KV-cache prefill (causal over its own positions, key-padded).

The kernels take every head_dim that the JAX dispatcher sends to its Pallas
kernels: 64 (the 160M and 410M decoders, the EVA-02 tower), 96 (GPT-NeoX-20B's
width), 128 (Pythia-1.4B, 6.9B, 12B), 256 (the 1B decoder), each a kernel of
its own, and every multiple of 128 from 384 on (heads of 384 or 512 of a
regrouped decoder), which the wide kernels take with a grid axis over
128-column slices of the output. Those are the bfloat16 kernels; at float32
inputs the float32 kernels take every such head_dim with float32-accurate
products (the Pallas kernels keep the matmul operands in the input dtype),
3xTF32 on the tensor cores in all three: the forward one CTA a query tile
over all of head_dim up to 512 (so each score tile is formed once), the dK/dV
and dQ kernels with a grid axis over slices of at most 128 output columns.

`LAUNCHES` counts kernel launches, one per launch, for callers that check
which path ran; `LAUNCHES_BY_HEAD_DIM[d]` counts the same launches at head_dim d,
and holds a head_dim from its first launch until `reset_launches()`;
`LAUNCHES_BY_DTYPE["bfloat16" | "float32"]` counts them by input dtype, and
holds a dtype likewise.
"""

from __future__ import annotations

import contextvars
from typing import Optional, Tuple

import torch

from mafed_tpu_torch.kernels.build import HEAD_DIMS, load_library, route, takes_head_dim

_NEG = torch.finfo(torch.float32).min

LAUNCHES = {"flash_fwd": 0, "flash_bwd_dkv": 0, "flash_bwd_dq": 0}
LAUNCHES_BY_HEAD_DIM: dict = {}
LAUNCHES_BY_DTYPE: dict = {}
# the stash of the remat policy of the decoder layer being run (models/gpt_neox.py
# RematPolicy), or None: FlashAttention's forward asks it for (o, lse)
REMAT_STASH: contextvars.ContextVar = contextvars.ContextVar("mafed_torch_remat_stash", default=None)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    LAUNCHES_BY_HEAD_DIM.clear()
    LAUNCHES_BY_DTYPE.clear()


def _count(name: str, head_dim: int, dtype: str) -> None:
    LAUNCHES[name] += 1
    LAUNCHES_BY_HEAD_DIM.setdefault(head_dim, dict.fromkeys(LAUNCHES, 0))[name] += 1
    LAUNCHES_BY_DTYPE.setdefault(dtype, dict.fromkeys(LAUNCHES, 0))[name] += 1


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _keep(mask: Optional[torch.Tensor], causal: bool, q_len: int, kv_len: int, device) -> torch.Tensor:
    """[B or 1, 1, q_len, kv_len] bool: which (query, key) pairs attend."""
    keep = torch.ones((1, 1, q_len, kv_len), dtype=torch.bool, device=device)
    if causal:
        keep = keep & torch.ones((q_len, kv_len), dtype=torch.bool, device=device).tril()
    if mask is not None:
        keep = keep & (mask > 0)[:, None, None, :]
    return keep


def _scores(q: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    # operands in the input dtype, products summed in f32 (bf16 x bf16 is
    # exact in f32), the scale applied to the f32 product
    return torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale


def flash_forward_plain(q, k, v, mask, causal: bool, scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense (o, lse) with the flash kernel's numerics: finfo(f32).min fill,
    explicit keep zeroing, lse = +inf on rows with no valid key (their o is 0)."""
    keep = _keep(mask, causal, q.shape[2], k.shape[2], q.device)
    s = torch.where(keep, _scores(q, k, scale), _NEG)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m) * keep
    l = p.sum(dim=-1)
    empty = l == 0.0
    l_safe = torch.where(empty, torch.ones_like(l), l)
    o = torch.matmul(p.to(q.dtype).float(), v.float()) / l_safe[..., None]
    lse = torch.where(empty, torch.full_like(l, float("inf")), m[..., 0] + torch.log(l_safe))
    return o.to(q.dtype), lse


def flash_backward_plain(q, k, v, mask, o, lse, do, causal: bool, scale: float):
    """Dense (dq, dk, dv) from the saved (o, lse), as the JAX custom VJP's
    dense backward computes them (_make_flash.bwd): p and ds rounded to the
    input dtype before their products."""
    dtype = q.dtype
    keep = _keep(mask, causal, q.shape[2], k.shape[2], q.device)
    p = torch.where(keep, torch.exp(_scores(q, k, scale) - lse[..., None]), 0.0)
    do32 = do.float()
    dv = torch.matmul(p.to(dtype).float().transpose(-1, -2), do32)
    dp = torch.matmul(do32, v.float().transpose(-1, -2))
    delta = (do32 * o.float()).sum(dim=-1, keepdim=True)
    ds = (p * (dp - delta)).to(dtype).float()
    dq = torch.matmul(ds, k.float()) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q.float()) * scale
    return dq.to(dtype), dk.to(k.dtype), dv.to(v.dtype)


def masked_attention(q, k, v, *, key_padding_mask=None, causal=False, causal_offset=None, scale=None):
    """Plain masked softmax attention, the counterpart of `xla_attention`
    (q pre-scaled; the KV-cache decode path)."""
    q_len, head_dim = q.shape[2], q.shape[3]
    k_len = k.shape[2]
    scale = (head_dim ** -0.5) if scale is None else scale
    scores = torch.matmul((q * scale).float(), k.float().transpose(-1, -2))
    if causal:
        offset = (k_len - q_len) if causal_offset is None else causal_offset
        qi = torch.arange(q_len, device=q.device)[:, None]
        ki = torch.arange(k_len, device=q.device)[None, :]
        scores = torch.where(ki <= qi + offset, scores, _NEG)
    if key_padding_mask is not None:
        scores = torch.where((key_padding_mask > 0)[:, None, None, :], scores, _NEG)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.matmul(probs.float(), v.float()).to(q.dtype)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _check_cuda(name: str, t: torch.Tensor, shape, dtype) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype} (the CUDA kernels take bfloat16 or float32, "
                        "q, k, v, do and o of one call alike)")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_launch(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} failed with CUDA error {err}")


def _mask_ptr(mask: Optional[torch.Tensor], batch: int, kv_len: int, device):
    if mask is None:
        return None
    if (
        mask.dtype != torch.int32 or tuple(mask.shape) != (batch, kv_len)
        or mask.device != device or not mask.is_contiguous()
    ):
        raise ValueError(f"mask must be a contiguous int32 [{batch}, {kv_len}] tensor on {device}")
    return mask.data_ptr()


def _dtype_name(t: torch.Tensor) -> str:
    """"bfloat16", "float32", ...: the name build.route takes (it refuses a dtype no kernel takes)."""
    return str(t.dtype).removeprefix("torch.")


def _check_qkv(q, k, v, causal: bool):
    """Shape, type and layout rules of the kernels; returns (batch, heads, q_len, kv_len, head_dim)."""
    batch, heads, q_len, d = q.shape
    kv_len = k.shape[2]
    _check_cuda("q", q, q.shape, q.dtype)
    _check_cuda("k", k, (batch, heads, kv_len, d), q.dtype)
    _check_cuda("v", v, (batch, heads, kv_len, d), q.dtype)
    if not takes_head_dim(d):
        dims = ", ".join(str(x) for x in HEAD_DIMS)
        raise ValueError(f"head_dim {d}: the CUDA flash kernels take head_dim {dims} and every multiple of 128 "
                         "from 384 on")
    if causal and kv_len != q_len:
        raise ValueError("causal flash attention needs kv_len == q_len")
    return batch, heads, q_len, kv_len, d


def _flash_forward_cuda(q, k, v, mask, causal: bool, scale: float):
    batch, heads, q_len, kv_len, d = _check_qkv(q, k, v, causal)
    mask_ptr = _mask_ptr(mask, batch, kv_len, q.device)
    dtype = _dtype_name(q)
    entry = route("flash_fwd", dtype, d).entry
    lib = load_library()
    o = torch.empty_like(q)
    lse = torch.empty((batch, heads, q_len), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = getattr(lib, entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr, o.data_ptr(), lse.data_ptr(),
            batch * heads, heads, q_len, kv_len, d, int(causal), scale, torch.cuda.current_stream().cuda_stream,
        )
    _check_launch(err, entry)
    _count("flash_fwd", d, dtype)
    return o, lse


def _check_bwd_inputs(q, k, v, mask, do, lse, delta, causal: bool):
    batch, heads, q_len, kv_len, d = _check_qkv(q, k, v, causal)
    _check_cuda("do", do, q.shape, q.dtype)
    _check_cuda("lse", lse, (batch, heads, q_len), torch.float32)
    _check_cuda("delta", delta, (batch, heads, q_len), torch.float32)
    return batch, heads, q_len, kv_len, d, _mask_ptr(mask, batch, kv_len, q.device)


def flash_bwd_dkv(q, k, v, mask, do, lse, delta, causal: bool, scale: float):
    """(dk, dv) from the dK/dV kernel; delta = rowsum(do * o) in f32. At
    float32 inputs the kernel forms its products in 3xTF32 on the tensor
    cores (csrc/flash_attn_f32.cu)."""
    batch, heads, q_len, kv_len, d, mask_ptr = _check_bwd_inputs(q, k, v, mask, do, lse, delta, causal)
    dtype = _dtype_name(q)
    entry = route("flash_bwd_dkv", dtype, d).entry
    lib = load_library()
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    with torch.cuda.device(q.device):
        err = getattr(lib, entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            mask_ptr, dk.data_ptr(), dv.data_ptr(),
            batch * heads, heads, q_len, kv_len, d, int(causal), scale, torch.cuda.current_stream().cuda_stream,
        )
    _check_launch(err, entry)
    _count("flash_bwd_dkv", d, dtype)
    return dk, dv


def flash_bwd_dq(q, k, v, mask, do, lse, delta, causal: bool, scale: float):
    """dq from the dQ kernel; delta = rowsum(do * o) in f32. At float32
    inputs the kernel forms its products in 3xTF32 on the tensor cores
    (csrc/flash_attn_f32.cu)."""
    batch, heads, q_len, kv_len, d, mask_ptr = _check_bwd_inputs(q, k, v, mask, do, lse, delta, causal)
    dtype = _dtype_name(q)
    entry = route("flash_bwd_dq", dtype, d).entry
    lib = load_library()
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = getattr(lib, entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            mask_ptr, dq.data_ptr(),
            batch * heads, heads, q_len, kv_len, d, int(causal), scale, torch.cuda.current_stream().cuda_stream,
        )
    _check_launch(err, entry)
    _count("flash_bwd_dq", d, dtype)
    return dq


def _flash_backward_cuda(q, k, v, mask, o, lse, do, causal: bool, scale: float):
    _check_cuda("o", o, q.shape, q.dtype)
    delta = (do.float() * o.float()).sum(dim=-1)
    dk, dv = flash_bwd_dkv(q, k, v, mask, do, lse, delta, causal, scale)
    dq = flash_bwd_dq(q, k, v, mask, do, lse, delta, causal, scale)
    return dq, dk, dv


def flash_forward(q, k, v, mask, causal: bool, scale: float):
    """(o, lse): the forward kernel on CUDA tensors, the plain version on CPU tensors."""
    if q.is_cuda:
        return _flash_forward_cuda(q, k, v, mask, causal, scale)
    if q.device.type == "cpu":
        return flash_forward_plain(q, k, v, mask, causal, scale)
    raise ValueError(f"no flash attention for device {q.device}")


def flash_backward(q, k, v, mask, o, lse, do, causal: bool, scale: float):
    """(dq, dk, dv): the dK/dV and dQ kernels on CUDA tensors, the plain version on CPU tensors."""
    if q.is_cuda:
        return _flash_backward_cuda(q, k, v, mask, o, lse, do, causal, scale)
    if q.device.type == "cpu":
        return flash_backward_plain(q, k, v, mask, o, lse, do, causal, scale)
    raise ValueError(f"no flash attention for device {q.device}")


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention; saves (q, k, v, mask, o, lse) like the
    JAX custom VJP (_make_flash.fwd) and recomputes p blockwise in backward."""

    @staticmethod
    def forward(ctx, q, k, v, mask, causal: bool, scale: float):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        stash = REMAT_STASH.get()
        if stash is None:
            o, lse = flash_forward(q, k, v, mask, causal, scale)
        else:  # under a remat policy: its stash may keep (o, lse), and hand them back in the recompute
            o, lse = stash.flash(lambda: flash_forward(q, k, v, mask, causal, scale))
        ctx.save_for_backward(q, k, v, mask, o, lse)
        ctx.causal = causal
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, mask, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_backward(q, k, v, mask, o, lse, do.contiguous(), ctx.causal, ctx.scale)
        return dq, dk, dv, None, None, None


def dot_product_attention(q, k, v, *, key_padding_mask=None, causal=False, causal_offset=None, scale=None):
    """Attention with [B, H, T, D] layout.

    Routed by shape, exactly as the JAX dispatcher routes on its TPU:
    shapes that it sends to its flash kernel (head_dim 64, 96, 128, 256 or a
    multiple of 128; q_len >= 8; causal only with kv_len == q_len; no
    causal_offset) go through `FlashAttention`, on the CPU and on CUDA alike;
    every other shape (head_dim 80, say, or a KV-cache decode step) takes
    `masked_attention`, its counterpart of `xla_attention`, on every device.
    The CUDA kernels take every flash head_dim: 64, 96, 128 and 256, and
    every multiple of 128 from 384 on in the wide kernels, at bfloat16; at
    float32 the float32 kernels take all of them.
    """
    head_dim = q.shape[-1]
    scale_f = float((head_dim ** -0.5) if scale is None else scale)
    q_len, kv_len = q.shape[2], k.shape[2]
    shapes_ok = head_dim % 128 == 0 or head_dim in (64, 96, 128, 256)
    shapes_ok = shapes_ok and q_len >= 8 and (not causal or kv_len == q_len)
    if causal_offset is not None or not shapes_ok:
        return masked_attention(
            q, k, v, key_padding_mask=key_padding_mask, causal=causal,
            causal_offset=causal_offset, scale=scale_f,
        )
    mask = None if key_padding_mask is None else key_padding_mask.to(torch.int32).contiguous()
    return FlashAttention.apply(q, k, v, mask, causal, scale_f)
