"""The port's CUDA flash kernels on the card, and the eval path through them
(marker `cuda`; they skip without a GPU).

This file imports no JAX, so it runs where only PyTorch is installed:

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest

The kernels are held against their dense plain versions in bf16 at atol =
rtol = 2e-2: the tiled kernels round p to bf16 against a running row maximum,
the plain versions against the final one, so single elements differ by a few
bf16 ulps. lse is float32 in both (atol 1e-4). Every kernel check runs at
each head_dim the kernels are built for (64, 96, 128 and 256) and at the two
that the regrouped decoders give the wide kernels (384 and 512), with the
models' scale head_dim^-0.5. The forward at 96 (unpadded tiles, two query
tiles a CTA) also takes non-causal calls with more keys than queries, gives
the same bits in two launches, and its (o, lse) feed the <96> backward
kernels to the plain backward's gradients; likewise the forward at 128 and
256 (two query tiles a CTA, each score tile formed once), at one query row,
at both sides of a tile edge and at odd counts of tiles, with and without
key padding; likewise the wide forward at 384, 512, 640 and 1024 (one CTA
a query tile and a piece of up to 512 columns, each score tile formed once
up to 512). The dK/dV kernel at 96 and 256 (dkv_cta) is held the same
way: q_len 1 to 336, 577 keys, bit-equal launches, and the whole backward
from the kernels' forward within one bf16 step (at least 2^-6, 0.0156) of
the plain one.

The float32 kernels (a `--compute_dtype float32` run) are held against the
plain versions at float32 at atol = rtol = 1e-4 (lse 1e-5): the three
kernels multiply in 3xTF32 on the tensor cores (each product within a few
2^-21 of its size, tests/test_torch_tf32_split.py), the plain versions in
float32 (TF32 off for their matmuls), in different orders, so they differ by
float32-level rounding only; at every head_dim above and 640 (five output
slices of the backward kernels, two of the forward). At the CE shapes of
head_dim 384 and 512 the backward and the forward stay within 4e-5, a limit
that one truncating accumulation chain over all of D and the keys (6.0e-5 /
7.3e-5 in the backward) would not meet. Two launches of each 3xTF32 kernel
give the same bits.
"""

import numpy as np
import pytest
import torch

from mafed_tpu_torch.kernels import attention as tattn

ATOL, RTOL = 2e-2, 2e-2
SCALE = 0.125  # head_dim 64's
HEAD_DIMS = [64, 96, 128, 256, 384, 512]


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")


def _inputs(b, h, t, seed, kv_len=None, masked=None, d=64, dtype=torch.bfloat16):
    """q, k, v, do of head_dim d on the card (bf16, or `dtype`) and an int32
    key mask: 3 left-padded keys in every sample, the keys of the range
    `masked` (start, stop) if given, and sample 0 masked entirely (its rows
    are empty)."""
    rng = np.random.default_rng(seed)
    kv_len = t if kv_len is None else kv_len
    q, k, v, g = (
        torch.from_numpy(rng.normal(size=(b, h, n, d)).astype(np.float32)).cuda().to(dtype)
        for n in (t, kv_len, kv_len, t)
    )
    mask = np.ones((b, kv_len), np.int32)
    mask[:, :3] = 0
    if masked is not None:
        mask[:, masked[0]:masked[1]] = 0
    mask[0, :] = 0
    return q, k, v, g, torch.from_numpy(mask).cuda()


# (q_len, kv_len, causal, masked key range): both sides of the 64-row tile
# edges, the window's 336, non-causal calls whose q and k tensor maps differ
# in length (one with a one-row last query tile against six key tiles), and a
# causal call whose second key tile is masked whole (its keep word is 0)
KERNEL_CASES = [(t, t, causal, None) for t in (63, 64, 65, 128, 129, 200, 336) for causal in (True, False)]
KERNEL_CASES += [(100, 257, False, None), (65, 336, False, None), (200, 200, True, (64, 128))]


@pytest.mark.cuda
@pytest.mark.parametrize("head_dim", HEAD_DIMS)
@pytest.mark.parametrize("q_len,kv_len,causal,masked", KERNEL_CASES)
def test_kernels_match_plain(gpu, q_len, kv_len, causal, masked, head_dim):
    q, k, v, g, mask = _inputs(2, 4, q_len, seed=11, kv_len=kv_len, masked=masked, d=head_dim)
    scale = head_dim ** -0.5
    o, lse = tattn.flash_forward(q, k, v, mask, causal, scale)
    o_p, lse_p = tattn.flash_forward_plain(q, k, v, mask, causal, scale)
    torch.testing.assert_close(o.float(), o_p.float(), atol=ATOL, rtol=RTOL)
    fin = torch.isfinite(lse_p)
    assert torch.equal(torch.isinf(lse), ~fin)
    assert not fin[0].any() and (o[0] == 0).all()
    torch.testing.assert_close(lse[fin], lse_p[fin], atol=1e-4, rtol=0)
    got = tattn.flash_backward(q, k, v, mask, o_p, lse_p, g, causal, scale)
    want = tattn.flash_backward_plain(q, k, v, mask, o_p, lse_p, g, causal, scale)
    for name, x, y in zip(("dq", "dk", "dv"), got, want):
        torch.testing.assert_close(x.float(), y.float(), atol=ATOL, rtol=RTOL, msg=name)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("head_dim", HEAD_DIMS)
def test_autograd_goes_through_the_kernels(gpu, head_dim):
    """dot_product_attention on the card: one launch of each kernel, at this
    head_dim, for one forward and backward, on the non-contiguous q/k/v views
    that the decoder hands it, with the plain versions' gradients."""
    q, k, v, g, mask = _inputs(2, 4, 96, seed=12, d=head_dim)
    scale = head_dim ** -0.5
    leaves = [x.transpose(1, 2).contiguous().requires_grad_(True) for x in (q, k, v)]  # [B, T, H, D]
    tattn.reset_launches()
    out = tattn.dot_product_attention(*(x.transpose(1, 2) for x in leaves), key_padding_mask=mask, causal=True)
    out.backward(g)
    assert tattn.LAUNCHES == {"flash_fwd": 1, "flash_bwd_dkv": 1, "flash_bwd_dq": 1}
    assert tattn.LAUNCHES_BY_HEAD_DIM[head_dim] == tattn.LAUNCHES
    o_p, lse_p = tattn.flash_forward_plain(q, k, v, mask, True, scale)
    want = tattn.flash_backward_plain(q, k, v, mask, o_p, lse_p, g, True, scale)
    torch.testing.assert_close(out.float(), o_p.float(), atol=ATOL, rtol=RTOL)
    for leaf, y in zip(leaves, want):
        torch.testing.assert_close(leaf.grad.transpose(1, 2).float(), y.float(), atol=ATOL, rtol=RTOL)


# head_dim 96's forward: non-causal calls with more keys than queries and a masked key range (CLIP-L/14-336's
# 577 keys; a one-row last query tile; a masked last key tile)
D96_CASES = [(129, 577, (500, 577)), (65, 577, (40, 80)), (320, 577, (560, 577))]


@pytest.mark.cuda
@pytest.mark.parametrize("q_len,kv_len,masked", D96_CASES)
def test_d96_forward_takes_more_keys_than_queries(gpu, q_len, kv_len, masked):
    q, k, v, _, mask = _inputs(2, 4, q_len, seed=21, kv_len=kv_len, masked=masked, d=96)
    scale = 96 ** -0.5
    tattn.reset_launches()
    o, lse = tattn.flash_forward(q, k, v, mask, False, scale)
    assert tattn.LAUNCHES_BY_HEAD_DIM == {96: {"flash_fwd": 1, "flash_bwd_dkv": 0, "flash_bwd_dq": 0}}
    o_p, lse_p = tattn.flash_forward_plain(q, k, v, mask, False, scale)
    torch.testing.assert_close(o.float(), o_p.float(), atol=ATOL, rtol=RTOL)
    fin = torch.isfinite(lse_p)
    assert torch.equal(torch.isinf(lse), ~fin) and not fin[0].any() and fin[1].all()
    torch.testing.assert_close(lse[fin], lse_p[fin], atol=1e-4, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,q_len,kv_len,causal", [(48, 64, 336, 336, True), (3, 2, 77, 77, True),
                                                      (2, 4, 129, 577, False)])
def test_d96_forward_is_bit_equal_across_launches(gpu, b, h, q_len, kv_len, causal):
    """Two launches of the forward at 96 give the same o and lse, bit for
    bit (no atomics; each warpgroup sums its own rows in one order), at the
    CE shape [48, 64, 336, 96] too."""
    q, k, v, _, mask = _inputs(b, h, q_len, seed=22, kv_len=kv_len, masked=(256, 276) if q_len == 336 else None, d=96)
    first = tattn.flash_forward(q, k, v, mask, causal, 96 ** -0.5)
    second = tattn.flash_forward(q, k, v, mask, causal, 96 ** -0.5)
    assert all(torch.equal(x, y) for x, y in zip(first, second))


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,q_len,kv_len,causal", [(8, 16, 336, 336, True), (2, 4, 129, 577, False)])
def test_d96_forward_feeds_the_backward_kernels(gpu, b, h, q_len, kv_len, causal):
    """The forward's (o, lse) at 96 into the <96> dK/dV and dQ kernels
    (dK/dV's unpadded tiles, dQ's padded 128-column one) give dq, dk, dv within the bf16
    tolerance of the plain backward from the plain forward's (o, lse)."""
    q, k, v, g, mask = _inputs(b, h, q_len, seed=23, kv_len=kv_len, masked=(256, 276) if causal else None, d=96)
    scale = 96 ** -0.5
    o, lse = tattn.flash_forward(q, k, v, mask, causal, scale)
    o_p, lse_p = tattn.flash_forward_plain(q, k, v, mask, causal, scale)
    got = tattn.flash_backward(q, k, v, mask, o, lse, g, causal, scale)
    want = tattn.flash_backward_plain(q, k, v, mask, o_p, lse_p, g, causal, scale)
    for name, x, y in zip(("dq", "dk", "dv"), got, want):
        torch.testing.assert_close(x.float(), y.float(), atol=ATOL, rtol=RTOL, msg=name)


# the forward at 128 and 256 (query tiles split over two warpgroups a CTA): one query row, both sides of a
# tile edge, an odd count of tiles (the prefill's 320: five) and the window's 336
SPLIT_Q_LENS = [1, 63, 64, 65, 320, 336]


@pytest.mark.cuda
@pytest.mark.parametrize("head_dim", [128, 256])
@pytest.mark.parametrize("q_len", SPLIT_Q_LENS)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("padded", [True, False])
def test_query_split_forward_matches_plain(gpu, head_dim, q_len, causal, padded):
    """The forward at 128 and 256 against the plain forward: o within the
    bf16 tolerance, lse in every row (+inf exactly on the empty rows of the
    masked sample, within 1e-4 elsewhere), with the key-padding mask or
    none."""
    q, k, v, _, mask = _inputs(3, 4, q_len, seed=24, d=head_dim)
    mask = mask if padded else None
    scale = head_dim ** -0.5
    o, lse = tattn.flash_forward(q, k, v, mask, causal, scale)
    o_p, lse_p = tattn.flash_forward_plain(q, k, v, mask, causal, scale)
    torch.testing.assert_close(o.float(), o_p.float(), atol=ATOL, rtol=RTOL)
    fin = torch.isfinite(lse_p)
    assert torch.equal(torch.isinf(lse), ~fin) and torch.equal(lse[~fin], lse_p[~fin])
    assert fin.all() if not padded else not fin[0].any() and (o[0] == 0).all()
    torch.testing.assert_close(lse[fin], lse_p[fin], atol=1e-4, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("head_dim,b,h", [(128, 48, 16), (256, 48, 8)])
@pytest.mark.parametrize("q_len", [77, 320, 336])
def test_query_split_forward_is_bit_equal_across_launches(gpu, head_dim, b, h, q_len):
    """Two launches of the forward at 128 and 256 give the same o and lse,
    bit for bit (each warpgroup sums its own rows in one order), at the CE
    shape and the prefill's five query tiles too."""
    q, k, v, _, mask = _inputs(b, h, q_len, seed=25, masked=(256, 276) if q_len > 276 else None, d=head_dim)
    first = tattn.flash_forward(q, k, v, mask, True, head_dim ** -0.5)
    second = tattn.flash_forward(q, k, v, mask, True, head_dim ** -0.5)
    assert all(torch.equal(x, y) for x, y in zip(first, second))


@pytest.mark.cuda
@pytest.mark.parametrize("head_dim", [128, 256])
@pytest.mark.parametrize("b,h,q_len,kv_len,causal", [(8, 8, 336, 336, True), (4, 4, 320, 320, True),
                                                      (2, 4, 129, 577, False)])
def test_query_split_forward_feeds_the_backward_kernels(gpu, head_dim, b, h, q_len, kv_len, causal):
    """The forward's (o, lse) at 128 and 256 into the <128> / <256> dK/dV and
    dQ kernels give dq, dk, dv within the bf16 tolerance of the plain
    backward from the plain forward's (o, lse)."""
    q, k, v, g, mask = _inputs(b, h, q_len, seed=26, kv_len=kv_len, masked=(256, 276) if causal else None,
                               d=head_dim)
    scale = head_dim ** -0.5
    o, lse = tattn.flash_forward(q, k, v, mask, causal, scale)
    o_p, lse_p = tattn.flash_forward_plain(q, k, v, mask, causal, scale)
    got = tattn.flash_backward(q, k, v, mask, o, lse, g, causal, scale)
    want = tattn.flash_backward_plain(q, k, v, mask, o_p, lse_p, g, causal, scale)
    for name, x, y in zip(("dq", "dk", "dv"), got, want):
        torch.testing.assert_close(x.float(), y.float(), atol=ATOL, rtol=RTOL, msg=name)


# the wide forward (one CTA a query tile and a piece of up to 512 columns, one warpgroup a 128-column slice,
# each score tile formed once up to 512 columns): 384 and 512 (one piece), 640 and 1024 (two pieces, the score
# in rounds; 640's second piece with an empty slice)
WIDE_FWD_HEAD_DIMS = [384, 512, 640, 1024]


@pytest.mark.cuda
@pytest.mark.parametrize("head_dim", WIDE_FWD_HEAD_DIMS)
@pytest.mark.parametrize("q_len", SPLIT_Q_LENS)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("padded", [True, False])
def test_wide_forward_matches_plain(gpu, head_dim, q_len, causal, padded):
    """The wide forward against the plain forward (one launch, at this
    head_dim): o within the bf16 tolerance, lse in every row (+inf exactly
    on the empty rows of the masked sample, within 1e-4 elsewhere), with
    the key-padding mask or none."""
    q, k, v, _, mask = _inputs(3, 4, q_len, seed=31, d=head_dim)
    mask = mask if padded else None
    scale = head_dim ** -0.5
    tattn.reset_launches()
    o, lse = tattn.flash_forward(q, k, v, mask, causal, scale)
    assert tattn.LAUNCHES_BY_HEAD_DIM == {head_dim: {"flash_fwd": 1, "flash_bwd_dkv": 0, "flash_bwd_dq": 0}}
    o_p, lse_p = tattn.flash_forward_plain(q, k, v, mask, causal, scale)
    torch.testing.assert_close(o.float(), o_p.float(), atol=ATOL, rtol=RTOL)
    fin = torch.isfinite(lse_p)
    assert torch.equal(torch.isinf(lse), ~fin) and torch.equal(lse[~fin], lse_p[~fin])
    assert fin.all() if not padded else not fin[0].any() and (o[0] == 0).all()
    torch.testing.assert_close(lse[fin], lse_p[fin], atol=1e-4, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("head_dim", WIDE_FWD_HEAD_DIMS)
@pytest.mark.parametrize("q_len,kv_len,masked", D96_CASES)
def test_wide_forward_takes_more_keys_than_queries(gpu, head_dim, q_len, kv_len, masked):
    """The wide forward, non-causal, 577 keys (CLIP-L/14-336's) against
    fewer queries and a masked key range: o and lse within the bf16
    tolerance and 1e-4 of the plain forward."""
    q, k, v, _, mask = _inputs(2, 4, q_len, seed=32, kv_len=kv_len, masked=masked, d=head_dim)
    scale = head_dim ** -0.5
    o, lse = tattn.flash_forward(q, k, v, mask, False, scale)
    o_p, lse_p = tattn.flash_forward_plain(q, k, v, mask, False, scale)
    torch.testing.assert_close(o.float(), o_p.float(), atol=ATOL, rtol=RTOL)
    fin = torch.isfinite(lse_p)
    assert torch.equal(torch.isinf(lse), ~fin) and not fin[0].any() and fin[1].all()
    torch.testing.assert_close(lse[fin], lse_p[fin], atol=1e-4, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("head_dim,b,h", [(384, 48, 16), (512, 48, 4), (640, 8, 4), (1024, 8, 2)])
@pytest.mark.parametrize("q_len", [77, 320, 336])
def test_wide_forward_is_bit_equal_across_launches(gpu, head_dim, b, h, q_len):
    """Two launches of the wide forward give the same o and lse, bit for
    bit (no atomics; every warpgroup sums the partial scores in one order),
    at the CE shapes of 384 and 512 and the prefill's five query tiles."""
    q, k, v, _, mask = _inputs(b, h, q_len, seed=33, masked=(256, 276) if q_len > 276 else None, d=head_dim)
    first = tattn.flash_forward(q, k, v, mask, True, head_dim ** -0.5)
    second = tattn.flash_forward(q, k, v, mask, True, head_dim ** -0.5)
    assert all(torch.equal(x, y) for x, y in zip(first, second))


# dK/dV at 96 and 256 (dkv_cta: at 96 unpadded tiles; at 256 each score tile's queries split over two
# warpgroups, P^T and dS^T exchanged through shared memory): one query row, both sides of a tile edge, odd
# counts of tiles and the window's 336
DKV_Q_LENS = [1, 63, 64, 65, 130, 320, 336]
DKV_BACKWARD_ATOL = 2.0 ** -6  # the least step of the whole backward's bound (0.0156)


def _bf16_step(x):
    """One bf16 step (2^-7 of the power of two at or below |x|) of each element, at least DKV_BACKWARD_ATOL."""
    return torch.clamp(torch.ldexp(torch.ones_like(x), torch.frexp(x.abs())[1] - 8), min=DKV_BACKWARD_ATOL)


def _dkv(q, k, v, g, mask, causal, scale):
    """The kernel's (dk, dv) and the plain backward's, from the plain forward's lse and delta."""
    o_p, lse_p = tattn.flash_forward_plain(q, k, v, mask, causal, scale)
    delta = (g.float() * o_p.float()).sum(-1)
    got = tattn.flash_bwd_dkv(q, k, v, mask, g, lse_p, delta, causal, scale)
    _, dk_p, dv_p = tattn.flash_backward_plain(q, k, v, mask, o_p, lse_p, g, causal, scale)
    return got, (dk_p, dv_p)


@pytest.mark.cuda
@pytest.mark.parametrize("head_dim", [96, 256])
@pytest.mark.parametrize("q_len", DKV_Q_LENS)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("padded", [True, False])
def test_dkv_cta_matches_plain(gpu, head_dim, q_len, causal, padded):
    """dK/dV at 96 and 256 against the plain backward (one launch, at this
    head_dim), with the key-padding mask or none: dk and dv within the bf16
    tolerance, and exactly 0 at the masked keys (the first three of every
    sample, every key of sample 0)."""
    q, k, v, g, mask = _inputs(3, 4, q_len, seed=27, d=head_dim)
    mask = mask if padded else None
    tattn.reset_launches()
    (dk, dv), (dk_p, dv_p) = _dkv(q, k, v, g, mask, causal, head_dim ** -0.5)
    assert tattn.LAUNCHES_BY_HEAD_DIM == {head_dim: {"flash_fwd": 0, "flash_bwd_dkv": 1, "flash_bwd_dq": 0}}
    torch.testing.assert_close(dk.float(), dk_p.float(), atol=ATOL, rtol=RTOL, msg="dk")
    torch.testing.assert_close(dv.float(), dv_p.float(), atol=ATOL, rtol=RTOL, msg="dv")
    if padded:
        assert (dk[0] == 0).all() and (dv[0] == 0).all()
        assert (dk[:, :, :3] == 0).all() and (dv[:, :, :3] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("head_dim", [96, 256])
@pytest.mark.parametrize("q_len,kv_len,masked", D96_CASES)
def test_dkv_cta_takes_more_keys_than_queries(gpu, head_dim, q_len, kv_len, masked):
    """dK/dV at 96 and 256, non-causal, 577 keys (CLIP-L/14-336's) against
    fewer queries and a masked key range: dk and dv within the bf16
    tolerance of the plain backward."""
    q, k, v, g, mask = _inputs(2, 4, q_len, seed=28, kv_len=kv_len, masked=masked, d=head_dim)
    (dk, dv), (dk_p, dv_p) = _dkv(q, k, v, g, mask, False, head_dim ** -0.5)
    torch.testing.assert_close(dk.float(), dk_p.float(), atol=ATOL, rtol=RTOL, msg="dk")
    torch.testing.assert_close(dv.float(), dv_p.float(), atol=ATOL, rtol=RTOL, msg="dv")


@pytest.mark.cuda
@pytest.mark.parametrize("head_dim,b,h", [(96, 48, 64), (256, 48, 8)])
@pytest.mark.parametrize("q_len", [77, 320, 336])
def test_dkv_cta_is_bit_equal_across_launches(gpu, head_dim, b, h, q_len):
    """Two launches of dK/dV at 96 and 256 give the same dk and dv, bit for
    bit (no atomics: each key tile's sums run in one order), at the CE shape
    too."""
    q, k, v, g, mask = _inputs(b, h, q_len, seed=29, masked=(256, 276) if q_len > 276 else None, d=head_dim)
    scale = head_dim ** -0.5
    o_p, lse_p = tattn.flash_forward_plain(q, k, v, mask, True, scale)
    delta = (g.float() * o_p.float()).sum(-1)
    first = tattn.flash_bwd_dkv(q, k, v, mask, g, lse_p, delta, True, scale)
    second = tattn.flash_bwd_dkv(q, k, v, mask, g, lse_p, delta, True, scale)
    assert all(torch.equal(x, y) for x, y in zip(first, second))


@pytest.mark.cuda
@pytest.mark.parametrize("head_dim,b,h", [(96, 48, 64), (256, 48, 8), (96, 3, 2), (256, 3, 2)])
def test_dkv_cta_in_the_whole_backward(gpu, head_dim, b, h):
    """The whole backward at 96 and 256 from the kernels' forward (o, lse),
    dq from the dQ kernel: dq, dk and dv within the bf16 tolerance of the
    plain backward from the plain forward's (o, lse), and each element
    within one bf16 step of the larger of the two values, at least 2^-6
    (0.0156): at the CE shape, the kernels' f32 sums and the plain ones
    round to neighbouring bf16 values, one step apart (0.03125 from 4 up),
    and a small unaligned one."""
    t = 336 if b == 48 else 77
    q, k, v, g, mask = _inputs(b, h, t, seed=30, masked=(256, 276) if t == 336 else None, d=head_dim)
    scale = head_dim ** -0.5
    o, lse = tattn.flash_forward(q, k, v, mask, True, scale)
    o_p, lse_p = tattn.flash_forward_plain(q, k, v, mask, True, scale)
    got = tattn.flash_backward(q, k, v, mask, o, lse, g, True, scale)
    want = tattn.flash_backward_plain(q, k, v, mask, o_p, lse_p, g, True, scale)
    for name, x, y in zip(("dq", "dk", "dv"), got, want):
        torch.testing.assert_close(x.float(), y.float(), atol=ATOL, rtol=RTOL, msg=name)
        x, y = x.float(), y.float()
        assert ((x - y).abs() <= _bf16_step(torch.maximum(x.abs(), y.abs()))).all(), name


F32_ATOL = F32_RTOL = 1e-4
F32_LSE_ATOL = 1e-5
F32_HEAD_DIMS = HEAD_DIMS + [640]
F32_CASES = [(63, 63, True, None), (65, 65, False, None), (129, 129, True, None), (336, 336, True, None),
             (100, 257, False, None), (200, 200, True, (64, 128))]


@pytest.mark.cuda
@pytest.mark.parametrize("head_dim", F32_HEAD_DIMS)
@pytest.mark.parametrize("q_len,kv_len,causal,masked", F32_CASES)
def test_f32_kernels_match_plain(gpu, q_len, kv_len, causal, masked, head_dim):
    """The float32 kernels against the plain versions at float32, one launch
    of each, counted under "float32"."""
    q, k, v, g, mask = _inputs(2, 4, q_len, seed=15, kv_len=kv_len, masked=masked, d=head_dim, dtype=torch.float32)
    scale = head_dim ** -0.5
    tattn.reset_launches()
    o, lse = tattn.flash_forward(q, k, v, mask, causal, scale)
    o_p, lse_p = tattn.flash_forward_plain(q, k, v, mask, causal, scale)
    assert o.dtype == torch.float32
    torch.testing.assert_close(o, o_p, atol=F32_ATOL, rtol=F32_RTOL)
    fin = torch.isfinite(lse_p)
    assert torch.equal(torch.isinf(lse), ~fin)
    assert not fin[0].any() and (o[0] == 0).all()
    torch.testing.assert_close(lse[fin], lse_p[fin], atol=F32_LSE_ATOL, rtol=0)
    got = tattn.flash_backward(q, k, v, mask, o_p, lse_p, g, causal, scale)
    want = tattn.flash_backward_plain(q, k, v, mask, o_p, lse_p, g, causal, scale)
    for name, x, y in zip(("dq", "dk", "dv"), got, want):
        assert x.dtype == torch.float32
        torch.testing.assert_close(x, y, atol=F32_ATOL, rtol=F32_RTOL, msg=name)
    torch.cuda.synchronize()
    assert tattn.LAUNCHES_BY_DTYPE == {"float32": {"flash_fwd": 1, "flash_bwd_dkv": 1, "flash_bwd_dq": 1}}


# The tensor core sums each mma.sync's products into its accumulator with
# truncation, so a chain of them drifts; the kernels add each stage's short
# chain to their sums with a rounding float32 add. At the 384 and 512 CE
# shapes one chain over all of D and the keys drifted to 6.0e-5 and 7.3e-5
# off the plain versions (scripts/flash_variants.py), within F32_ATOL; a
# chain a stage keeps the kernels under 2e-5, and this limit tells the two
# apart.
F32_DRIFT_ATOL = 4e-5


@pytest.mark.cuda
@pytest.mark.parametrize("head_dim,batch,heads", [(384, 48, 16), (512, 48, 4)])
def test_f32_backward_kernels_do_not_drift_at_wide_heads(gpu, head_dim, batch, heads):
    """dq, dk and dv of the 3xTF32 kernels at a wide model's CE shape
    (causal, 336 rows, 20 padded keys) within F32_DRIFT_ATOL of the plain
    versions at float32."""
    q, k, v, g, mask = _inputs(batch, heads, 336, seed=17, masked=(256, 276), d=head_dim, dtype=torch.float32)
    scale = head_dim ** -0.5
    o_p, lse_p = tattn.flash_forward_plain(q, k, v, mask, True, scale)
    got = tattn.flash_backward(q, k, v, mask, o_p, lse_p, g, True, scale)
    want = tattn.flash_backward_plain(q, k, v, mask, o_p, lse_p, g, True, scale)
    for name, x, y in zip(("dq", "dk", "dv"), got, want):
        err = (x - y).abs().max().item()
        assert err <= F32_DRIFT_ATOL, f"{name}: largest |kernel - plain| {err:.3g} > {F32_DRIFT_ATOL}"


@pytest.mark.cuda
@pytest.mark.parametrize("head_dim,batch,heads", [(384, 48, 16), (512, 48, 4)])
def test_f32_forward_kernel_does_not_drift_at_wide_heads(gpu, head_dim, batch, heads):
    """o and lse of the 3xTF32 forward (one CTA a query tile over all of D)
    at a wide model's CE shape (causal, 336 rows, 20 padded keys) within
    F32_DRIFT_ATOL of the plain version at float32, empty rows alike."""
    q, k, v, _, mask = _inputs(batch, heads, 336, seed=17, masked=(256, 276), d=head_dim, dtype=torch.float32)
    scale = head_dim ** -0.5
    o, lse = tattn.flash_forward(q, k, v, mask, True, scale)
    o_p, lse_p = tattn.flash_forward_plain(q, k, v, mask, True, scale)
    fin = torch.isfinite(lse_p)
    assert torch.equal(torch.isinf(lse), ~fin)
    for name, x, y in (("o", o, o_p), ("lse", lse[fin], lse_p[fin])):
        err = (x - y).abs().max().item()
        assert err <= F32_DRIFT_ATOL, f"{name}: largest |kernel - plain| {err:.3g} > {F32_DRIFT_ATOL}"


@pytest.mark.cuda
@pytest.mark.parametrize("head_dim", F32_HEAD_DIMS)
def test_f32_forward_kernel_is_bit_equal_across_launches(gpu, head_dim):
    """Two launches of the 3xTF32 forward on the same inputs give the same
    o and lse bits (no atomics; every reader of a score takes the two
    halves' sums in one order; at 640 the two slices of a tile run the same
    score instructions)."""
    q, k, v, _, mask = _inputs(2, 4, 200, seed=16, masked=(64, 128), d=head_dim, dtype=torch.float32)
    scale = head_dim ** -0.5
    runs = [tattn.flash_forward(q, k, v, mask, True, scale) for _ in range(2)]
    torch.cuda.synchronize()
    for name, first, second in zip(("o", "lse"), *runs):
        assert torch.equal(first, second), name


@pytest.mark.cuda
@pytest.mark.parametrize("head_dim", F32_HEAD_DIMS)
def test_f32_backward_kernels_are_bit_equal_across_launches(gpu, head_dim):
    """Two launches of each 3xTF32 backward kernel on the same inputs give
    the same bits (no atomics; the slices of a tile run the same
    instructions), as the bit-equal resumes of a float32 run need."""
    q, k, v, g, mask = _inputs(2, 4, 200, seed=16, masked=(64, 128), d=head_dim, dtype=torch.float32)
    scale = head_dim ** -0.5
    o, lse = tattn.flash_forward_plain(q, k, v, mask, True, scale)
    delta = (g * o).sum(-1)
    runs = [(*tattn.flash_bwd_dkv(q, k, v, mask, g, lse, delta, True, scale),
             tattn.flash_bwd_dq(q, k, v, mask, g, lse, delta, True, scale)) for _ in range(2)]
    torch.cuda.synchronize()
    for name, first, second in zip(("dk", "dv", "dq"), *runs):
        assert torch.equal(first, second), name


@pytest.mark.cuda
def test_f32_window_on_card_matches_cpu(gpu):
    """A tiny fused MAFED window at compute_dtype float32 on the card (the
    float32 kernels) against the same window on the CPU (plain versions):
    losses and grad norm within rtol 1e-4; every launch a float32 one, 5 L - 2
    forwards and 2 L of each backward."""
    from mafed_tpu_torch.core.config import ModelConfig, TrainConfig, VisionConfig
    from mafed_tpu_torch.models.vl_pythia import init_model
    from mafed_tpu_torch.optim.optimizer import build_optimizer, set_schedule
    from mafed_tpu_torch.training.step import make_mafed_window_step
    from mafed_tpu_torch.training.train_state import TrainState, make_teacher, trainable_parameters

    cfg = ModelConfig(vocab_size=512, num_attention_heads=2, **DECODERS[64],
                      vision=VisionConfig(img_size=56, embed_dim=128, depth=2, num_heads=2))
    train_cfg = TrainConfig(optim="adamw", compute_dtype="float32", distillation_coeff=1.0,
                            distillation_modality_weighing_strategy="balanced",
                            distillation_layer_weighing_strategy="discounted", distillation_layer_discount=0.5)
    batches = [_tiny_train_batch(20 + i) for i in range(4)]
    got = {}
    for device in ("cpu", "cuda"):
        model = init_model(cfg, seed=0, device="cpu").to(device)
        teacher = make_teacher(model)
        trainable = trainable_parameters(model)
        opt = build_optimizer(train_cfg, trainable)
        state = TrainState(0, model, set_schedule(opt.init(trainable), 0, 10))
        ce = {k: torch.stack([b[k] for b in batches[:3]]).to(device) for k in batches[0]}
        distill = {k: v.to(device) for k, v in batches[3].items()}
        lang = torch.full((cfg.num_hidden_layers - 1,), 0.5, device=device)
        tattn.reset_launches()
        step = make_mafed_window_step(cfg, train_cfg, opt, n_ce=3, device=device)
        _, m = step(state, teacher, ce, distill, lang)
        got[device] = [float(m[k]) for k in ("loss", "ce_loss", "distill_loss", "grad_norm")]
    layers = cfg.num_hidden_layers
    assert tattn.LAUNCHES_BY_DTYPE == {"float32": {"flash_fwd": 5 * layers - 2, "flash_bwd_dkv": 2 * layers,
                                                   "flash_bwd_dq": 2 * layers}}
    np.testing.assert_allclose(got["cuda"], got["cpu"], rtol=1e-4)


@pytest.mark.cuda
def test_trainer_cli_trains_at_float32_on_card(gpu, tmp_path):
    """The shipped config through the CLI's parser with --compute_dtype
    float32 and a tiny model on the card (it raised TypeError at the first
    attention before the float32 kernels): a CE task and a MAFED task, every
    window launch a float32 one, eval's and the tower's bfloat16."""
    import chip_smoke  # its synthetic data writer and the sequence's command line (it imports the port only)
    from mafed_tpu_torch.core.config import build_arg_parser, parse_with_config
    from mafed_tpu_torch.trainer.continual import ContinualLearningTrainer

    root = str(tmp_path)
    chip_smoke.write_synthetic_vqa(root, ("taskA", "taskB"), 32, 8)
    argv = chip_smoke.cl_sequence_argv(root) + chip_smoke.STREAMING_SWITCHES + [
        "--compute_dtype", "float32", "--batch_size", "4", "--cl_memory", "8", "--val_batch_size", "4"]
    cfg = parse_with_config(build_arg_parser(), argv)
    model_cfg = chip_smoke.tiny_config(64)
    tattn.reset_launches()
    result = ContinualLearningTrainer(cfg, model_cfg=model_cfg, synthetic_images=True, device="cuda").main()
    assert np.isfinite(result["accuracy_matrix"]).all()
    windows = chip_smoke.sequence_launches(cfg, model_cfg, 2, 2, 0, 0, 0, in_step_teacher=True)[64]
    assert tattn.LAUNCHES_BY_DTYPE["float32"] == windows
    assert tattn.LAUNCHES_BY_DTYPE["bfloat16"]["flash_fwd"] > 0
    assert tattn.LAUNCHES_BY_DTYPE["bfloat16"]["flash_bwd_dq"] == 0


@pytest.mark.cuda
def test_cuda_calls_the_kernels_cannot_take_raise(gpu):
    """The wrappers raise on what the kernels do not take: a float16 tensor
    (the kernels take bfloat16 and float32), a float32 k beside a bfloat16 q,
    a head_dim that is neither one of 64, 96, 128, 256 nor a multiple of 128
    from 384 on (320: dot_product_attention sends it to masked_attention, as
    the JAX dispatcher sends it to xla_attention, so only a direct call
    reaches the wrapper), a non-contiguous tensor."""
    q, k, v, _, mask = _inputs(1, 2, 64, seed=13)
    with pytest.raises(TypeError, match="bfloat16"):
        tattn.flash_forward(q.half(), k.half(), v.half(), mask, True, SCALE)
    with pytest.raises(TypeError, match="bfloat16"):
        tattn.flash_forward(q, k.float(), v, mask, True, SCALE)
    odd = torch.zeros(1, 2, 64, 320, dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError, match="head_dim 320"):
        tattn.flash_forward(odd, odd, odd, None, True, SCALE)
    lse = torch.zeros(1, 2, 64, device="cuda")
    with pytest.raises(ValueError, match="head_dim 320"):
        tattn.flash_bwd_dq(odd, odd, odd, None, odd, lse, lse, True, SCALE)
    with pytest.raises(ValueError, match="contiguous"):
        tattn.flash_forward(q.transpose(2, 3), k, v, None, False, SCALE)


# shapes that the JAX dispatcher sends to xla_attention: head_dim 80
# (Pythia-2.8B's heads), q_len under 8, causal with kv_len != q_len
XLA_SHAPES = [((2, 32, 336, 80), 336, True), ((2, 4, 4, 64), 4, False), ((2, 4, 24, 128), 40, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("q_shape,kv_len,causal", XLA_SHAPES)
def test_shapes_jax_sends_to_xla_take_masked_attention_on_card(gpu, q_shape, kv_len, causal):
    """dot_product_attention on the card returns masked_attention's result
    for these shapes, bit for bit, with no flash launch (before the routing
    followed the JAX dispatcher, they raised on CUDA tensors)."""
    b, h, t, d = q_shape
    q, k, v, _, mask = _inputs(b, h, t, seed=14, kv_len=kv_len, d=d)
    tattn.reset_launches()
    got = tattn.dot_product_attention(q, k, v, key_padding_mask=mask, causal=causal)
    want = tattn.masked_attention(q, k, v, key_padding_mask=mask, causal=causal)
    assert tattn.LAUNCHES == {"flash_fwd": 0, "flash_bwd_dkv": 0, "flash_bwd_dq": 0}
    assert got.is_cuda and torch.equal(got, want)


# tiny decoders of 2 heads: of 64; of 96 as GPT-NeoX-20B's; of 128 as
# Pythia-1.4B's; of 256 as the 1B preset's; of 384 and 512 as the regrouped
# decoders' (the wide kernels)
DECODERS = {64: dict(hidden_size=128, num_hidden_layers=3, intermediate_size=256),
            96: dict(hidden_size=192, num_hidden_layers=2, intermediate_size=384),
            128: dict(hidden_size=256, num_hidden_layers=2, intermediate_size=512),
            256: dict(hidden_size=512, num_hidden_layers=2, intermediate_size=1024),
            384: dict(hidden_size=768, num_hidden_layers=2, intermediate_size=1536),
            512: dict(hidden_size=1024, num_hidden_layers=2, intermediate_size=2048)}


def _tiny_eval_model(device, head_dim=64):
    """A tiny VL-Pythia whose tower has heads of 64 (16 patches + CLS) and
    whose decoder has 2 heads of `head_dim`, seeded on the CPU, then moved;
    bf16 throughout."""
    from mafed_tpu_torch.core.config import ModelConfig, VisionConfig
    from mafed_tpu_torch.models.vl_pythia import init_model

    cfg = ModelConfig(vocab_size=512, num_attention_heads=2, **DECODERS[head_dim],
                      vision=VisionConfig(img_size=56, embed_dim=128, depth=2, num_heads=2))
    return cfg, init_model(cfg, seed=0, device="cpu", dtype=torch.bfloat16).to(device)


def _eval_batch(seed):
    rng = np.random.default_rng(seed)
    mask = np.ones((4, 12), np.int32)
    mask[:, :3] = 0
    return {"input_ids": torch.from_numpy(rng.integers(1, 500, size=(4, 12)).astype(np.int32)),
            "attention_mask": torch.from_numpy(mask),
            "pixels": torch.from_numpy(rng.integers(0, 256, size=(4, 56, 56, 3)).astype(np.uint8))}


@pytest.mark.cuda
def test_tower_on_card_matches_cpu(gpu):
    """The EVA-02 tower through the flash forward kernel (one launch per
    block) against the same tower on the CPU (plain version): relative norm
    error within 3e-2 in bf16."""
    from mafed_tpu_torch.data.images import make_normalizer, prep_pixels

    feats = {}
    for device in ("cpu", "cuda"):
        cfg, model = _tiny_eval_model(device)
        px = prep_pixels({"pixels": _eval_batch(1)["pixels"].to(device)}, make_normalizer(cfg.vision), torch.bfloat16)
        tattn.reset_launches()
        with torch.inference_mode():
            feats[device] = model.vision_encoder.forward_features(px, dtype=torch.bfloat16).float().cpu()
    assert tattn.LAUNCHES["flash_fwd"] == cfg.vision.depth
    err = (feats["cuda"] - feats["cpu"]).norm() / feats["cpu"].norm()
    assert err <= 3e-2, err


@pytest.mark.cuda
def test_decode_is_cache_invariant_on_card(gpu):
    """Each token of the cached decode on the card, up to a row's first EOS,
    is within bf16 tolerance (2e-2 |max|) of the argmax of a no-cache forward
    over the prefix and the tokens before it."""
    from mafed_tpu_torch.data.images import make_normalizer, prep_pixels
    from mafed_tpu_torch.evaluation.decode import make_greedy_decoder
    from mafed_tpu_torch.models import vl_pythia as V

    cfg, model = _tiny_eval_model("cuda")
    batch = _eval_batch(2)
    max_new = 8
    tattn.reset_launches()
    toks = make_greedy_decoder(cfg, max_new_tokens=max_new)(model, batch).cpu()
    assert tattn.LAUNCHES["flash_fwd"] == cfg.vision.depth + cfg.num_hidden_layers
    ids = torch.cat([batch["input_ids"], toks[:, :-1]], dim=1).cuda()
    mask = torch.cat([batch["attention_mask"], torch.ones(4, max_new - 1, dtype=torch.int32)], dim=1).cuda()
    with torch.inference_mode():
        px = prep_pixels({"pixels": batch["pixels"].cuda()}, make_normalizer(cfg.vision), torch.bfloat16)
        logits = V.forward(model, ids, mask, pixel_values=px).logits[:, -max_new:].float().cpu()
    for r in range(4):
        for k in range(max_new):
            row = logits[r, k]
            assert row.max() - row[toks[r, k]] <= 2e-2 * row.abs().max(), (r, k)
            if toks[r, k] == 0:
                break


def _tiny_train_batch(seed, b=4, text_len=24):
    rng = np.random.default_rng(seed)
    mask = np.ones((b, text_len), np.int32)
    mask[:, :5] = 0
    ids = rng.integers(1, 500, size=(b, text_len)).astype(np.int32)
    labels = ids.copy()
    labels[:, :-6] = -100
    return {"input_ids": torch.from_numpy(ids), "attention_mask": torch.from_numpy(mask),
            "labels": torch.from_numpy(labels),
            "patches": torch.from_numpy(rng.normal(size=(b, 16, 128)).astype(np.float32)).to(torch.bfloat16)}


@pytest.mark.cuda
@pytest.mark.parametrize("head_dim", HEAD_DIMS)
@pytest.mark.parametrize("remat", [False, True])
def test_train_step_on_card_matches_cpu(gpu, remat, head_dim):
    """One bf16 train step of the tiny model (decoder heads of `head_dim`) on
    the card (kernels) against the CPU (plain versions): loss and grad norm
    within rtol 3e-2; without remat one launch of each kernel per layer, with
    remat one more forward, all at the decoder's head_dim."""
    from mafed_tpu_torch.core.config import TrainConfig
    from mafed_tpu_torch.optim.optimizer import build_optimizer, set_schedule
    from mafed_tpu_torch.training.step import make_train_step
    from mafed_tpu_torch.training.train_state import TrainState, trainable_parameters

    train_cfg = TrainConfig(optim="adamw", remat=remat)
    got = {}
    for device in ("cpu", "cuda"):
        cfg, model = _tiny_eval_model(device, head_dim)
        model.float()  # trainable parameters in f32, as the trainer holds them
        trainable = trainable_parameters(model)
        opt = build_optimizer(train_cfg, trainable)
        state = TrainState(0, model, set_schedule(opt.init(trainable), 0, 10))
        tattn.reset_launches()
        batch = {k: v.to(device) for k, v in _tiny_train_batch(3).items()}
        _, m = make_train_step(cfg, train_cfg, opt, device=device)(state, batch)
        got[device] = (float(m["loss"]), float(m["grad_norm"]))
    layers = cfg.num_hidden_layers
    assert tattn.LAUNCHES == {"flash_fwd": layers * (2 if remat else 1), "flash_bwd_dkv": layers, "flash_bwd_dq": layers}
    assert tattn.LAUNCHES_BY_HEAD_DIM[head_dim] == tattn.LAUNCHES
    np.testing.assert_allclose(got["cuda"], got["cpu"], rtol=3e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["attn", "dots"])
def test_remat_policy_on_card(gpu, policy):
    """A train step with per-layer remat under a named policy on the card: the
    loss and grad norm of full recompute's, bit for bit; under "attn" the
    backward relaunches no flash forward, under "dots" one per layer."""
    from mafed_tpu_torch.core.config import TrainConfig
    from mafed_tpu_torch.optim.optimizer import build_optimizer, set_schedule
    from mafed_tpu_torch.training.step import make_train_step
    from mafed_tpu_torch.training.train_state import TrainState, trainable_parameters

    got = {}
    for name in ("", policy):
        train_cfg = TrainConfig(optim="adamw", remat=True, remat_policy=name)
        cfg, model = _tiny_eval_model("cuda")
        model.float()
        trainable = trainable_parameters(model)
        opt = build_optimizer(train_cfg, trainable)
        state = TrainState(0, model, set_schedule(opt.init(trainable), 0, 10))
        tattn.reset_launches()
        _, m = make_train_step(cfg, train_cfg, opt, device="cuda")(state, {k: v.cuda() for k, v in _tiny_train_batch(3).items()})
        got[name] = (float(m["loss"]), float(m["grad_norm"]), dict(tattn.LAUNCHES))
    layers = cfg.num_hidden_layers
    assert got[policy][:2] == got[""][:2]
    assert got[policy][2]["flash_fwd"] == layers * (1 if policy == "attn" else 2)


@pytest.mark.cuda
def test_clip_tower_on_card_matches_cpu(gpu):
    """A tiny CLIP tower (heads of 64, 16 patches + CLS) through the flash
    forward kernel (one launch per layer) against the CPU: relative norm
    error within 3e-2 in bf16."""
    from mafed_tpu_torch.core.config import VisionConfig
    from mafed_tpu_torch.models.clip_vit import CLIPVisionModel, init_weights

    vision = VisionConfig(backbone="clip", img_size=56, embed_dim=128, depth=2, num_heads=2, mlp_ratio=4.0)
    tower = CLIPVisionModel(vision, device="cpu")
    init_weights(tower, torch.Generator().manual_seed(0))
    pixels = torch.from_numpy(np.random.default_rng(4).normal(size=(4, 3, 56, 56)).astype(np.float32))
    feats = {}
    for device in ("cpu", "cuda"):
        tattn.reset_launches()
        with torch.inference_mode():
            feats[device] = tower.to(device).hidden_states(pixels.to(device), dtype=torch.bfloat16)[-2].float().cpu()
    assert tattn.LAUNCHES["flash_fwd"] == vision.depth
    err = (feats["cuda"] - feats["cpu"]).norm() / feats["cpu"].norm()
    assert err <= 3e-2, err


@pytest.mark.cuda
def test_adaptive_weights_on_card_match_cpu(gpu):
    """The adaptive-weight sums (a gradient through both backward kernels with
    respect to a zero perturbation) on the card against the CPU: relative
    norm error within 5e-2 in bf16."""
    from mafed_tpu_torch.core.config import TrainConfig
    from mafed_tpu_torch.training.step import make_adaptive_weights_fn

    sums = {}
    for device in ("cpu", "cuda"):
        cfg, model = _tiny_eval_model(device)
        fn = make_adaptive_weights_fn(cfg, TrainConfig(), [0, 1], device=device)
        tattn.reset_launches()
        out = fn(model, {k: v.to(device) for k, v in _tiny_train_batch(4).items()})
        sums[device] = torch.cat([out[0], out[1]]).float().cpu()
    assert tattn.LAUNCHES == {k: cfg.num_hidden_layers for k in tattn.LAUNCHES}
    err = (sums["cuda"] - sums["cpu"]).norm() / sums["cpu"].norm()
    assert err <= 5e-2, err


@pytest.mark.cuda
def test_prefetcher_copies_on_a_side_stream(gpu):
    """DevicePrefetcher (depth 3, pinned copies on a side stream): every
    batch arrives on the card equal to its host arrays and in order, while
    the consumer reads each batch and drops it with later copies in flight."""
    from mafed_tpu_torch.data.prefetch import DevicePrefetcher

    rng = np.random.default_rng(0)
    host = [{"input_ids": rng.integers(0, 100, size=(16, 80)).astype(np.int32),
             "patches": torch.from_numpy(rng.normal(size=(16, 256, 64)).astype(np.float32)).to(torch.bfloat16),
             "qids": [i]} for i in range(12)]
    sums = []
    for i, batch in enumerate(DevicePrefetcher(iter(host), "cuda", depth=3)):
        assert batch["input_ids"].is_cuda and batch["patches"].is_cuda and batch["qids"] == [i]
        sums.append((batch["input_ids"].long().sum(), batch["patches"].float().sum()))
        del batch
    torch.cuda.synchronize()
    for (ids, patches), h in zip(sums, host):
        assert int(ids) == int(h["input_ids"].astype(np.int64).sum())
        assert float(patches) == pytest.approx(float(h["patches"].float().sum()), rel=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("fused_window", [True, False])
def test_cl_sequence_on_card_matches_cpu(gpu, tmp_path, fused_window):
    """A tiny two-task featdistill sequence (bf16) on the card and on the CPU
    from the same weights: the same steps by task, and every logged train
    loss and grad norm within rtol 5e-2. Without fused windows the batches
    reach the card through DevicePrefetcher."""
    import json
    import os

    import chip_smoke  # its synthetic data writer (it imports the port only)
    from mafed_tpu_torch.core.config import ModelConfig, TrainConfig, VisionConfig
    from mafed_tpu_torch.models.vl_pythia import init_model
    from mafed_tpu_torch.trainer.continual import ContinualLearningTrainer

    model_cfg = ModelConfig(vocab_size=512, num_attention_heads=2, **DECODERS[64],
                            vision=VisionConfig(img_size=56, embed_dim=128, depth=2, num_heads=2))
    params = init_model(model_cfg, seed=0, device="cpu").state_dict()
    steps, logged = {}, {}
    for device in ("cpu", "cuda"):
        root = str(tmp_path / device)
        chip_smoke.write_synthetic_vqa(root, ("taskA", "taskB"), 32, 8)
        cfg = TrainConfig(
            output_dir=os.path.join(root, "out"), data_dir=root, question_task_ids=os.path.join(root, "contvqa"),
            exp="tiny", tasks=["taskA", "taskB"], train_img_dirs=["unused"], val_img_dirs=["unused"],
            batch_size=4, val_batch_size=4, accumulate_grad_batches=4, replay_interval=4, cl_memory=8,
            cl_method="featdistill", distillation_modality_weighing_strategy="balanced",
            distillation_layer_weighing_strategy="discounted", distillation_layer_discount=0.5,
            fused_window=fused_window, epochs=[1, 1], max_txt_len=24, text_pad_multiple=8, learning_rate=1e-3,
            optim="adamw", log_every=1, n_workers=2, val_num_workers=2, allow_tokenizer_fallback=True,
            device_vision_table_mb=0, teacher_state_cache="off", mesh_shape=[1, 1],
        )
        trainer = ContinualLearningTrainer(cfg, model_cfg=model_cfg, synthetic_images=True, init_params=params,
                                           device=device)
        result = trainer.main()
        assert np.isfinite(result["accuracy_matrix"]).all()
        steps[device] = [log["steps"] for log in trainer.fit_logs]
        with open(os.path.join(cfg.output_dir, "log", "metrics.jsonl")) as f:
            records = [json.loads(line) for line in f]
        logged[device] = [r[k] for r in records for k in sorted(r) if k.endswith(("train_loss", "grad_norm"))]
    assert steps["cuda"] == steps["cpu"]
    assert len(logged["cuda"]) == len(logged["cpu"]) > 0
    np.testing.assert_allclose(logged["cuda"], logged["cpu"], rtol=5e-2)
