"""The 3xTF32 products of the port's float32 kernels
(mafed_tpu_torch/csrc/flash_attn_f32.cu), emulated on the CPU.

The forward, dK/dV and dQ kernels at float32 inputs multiply on the tensor
cores:
each f32 operand x is split into big = x rounded to TF32 as cvt.rna rounds
it (10 mantissa bits, nearest, ties away from zero) and small = x - big,
which the tensor core reads truncated to TF32, and each product is summed as
a_small b_big + a_big b_small + a_big b_big in float32. The card's
instruction cannot run here, so `tests/torch_helpers.py` emulates it:
`round_to_tf32` rounds as cvt.rna does, `split_tf32` splits as the kernels
do, and `matmul_3xtf32` forms the three products as float32 matmuls of
TF32-valued tensors (whose products are exact in float32). With it:

* the split is needed and enough: over the kernels' products at their
  shapes and scales (q k^T at head_dim 64 ... 512, P^T dO over 336 keys),
  against float64, its largest error stays within SPLIT_FACTOR times a
  float32 matmul's, and a single TF32 product's is at least TF32_FACTOR
  times larger than the split's;
* the float32 backward with every product through the emulation stays
  within atol = rtol = 1e-5 of the port's flash_backward_plain (float32
  products) and within F32_ATOL = 1e-4, the card's tolerance for the
  kernels (chip_smoke.py), of the JAX package's Pallas backward run in
  interpret mode under `_PALLAS_BWD_MODE = "always"`, in causal, padded and
  empty-row cases at head_dim 64 and 256;
* the float32 forward with both products (S = q k^T, O = P V) through the
  emulation (`flash_forward_3xtf32`) stays within 1e-5 of
  flash_forward_plain, o and lse, and within F32_ATOL of the JAX package's
  Pallas forward (`_flash_forward`, interpret mode) at float32 inputs, in
  the same cases at every head_dim from 64 to 512; empty rows have lse +inf
  and o exactly 0 in all three.

What the emulation leaves out: the tensor core sums each mma.sync's
products into its accumulator with truncation, where these matmuls sum in
float32 rounded to nearest. The kernels keep that drift small by adding each
stage's short chain to their sums with a rounding add; the emulation does
not model it, so these tests cannot see it, and the card test
`tests/test_torch_cuda.py::test_f32_backward_kernels_do_not_drift_at_wide_heads`
bounds it instead. The 1e-5 agreement below is the operands' rounding alone.

Torch runs on one CPU thread (`one_torch_thread`, as in
tests/test_torch_attention.py), so each matmul sums in one fixed order.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax._src import compilation_cache

from mafed_tpu.kernels import attention as jattn
from mafed_tpu_torch.kernels import attention as tattn
from tests.torch_helpers import (  # noqa: F401 (one_torch_thread is a fixture)
    flash_backward_3xtf32, flash_forward_3xtf32, matmul_3xtf32, one_torch_thread, round_to_tf32, split_tf32,
)

# The split's largest error against float64 within this factor of a float32 matmul's (measured: 0.73-1.55
# over the shapes below), and a single TF32 product's at least this factor above the split's (measured:
# 320-1010)
SPLIT_FACTOR = 3.0
TF32_FACTOR = 100.0
PLAIN_ATOL = PLAIN_RTOL = 1e-5
F32_ATOL = F32_RTOL = 1e-4
HEAD_DIMS = [64, 96, 128, 256, 384, 512]


@pytest.fixture(scope="module", autouse=True)
def no_persistent_cache():
    """Every JAX reference compiled in this module's process, as in
    tests/test_torch_attention.py; the cache settings restored afterwards."""
    was = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    compilation_cache.reset_cache()
    jax.clear_caches()
    yield
    jax.config.update("jax_enable_compilation_cache", was)
    compilation_cache.reset_cache()


@pytest.fixture
def interpret_mode():
    jattn._INTERPRET = True
    jattn._PALLAS_BWD_MODE = "always"
    yield
    jattn._INTERPRET = False
    jattn._PALLAS_BWD_MODE = "auto"


def test_round_to_tf32_rounds_as_cvt_rna():
    """Ten mantissa bits kept, to nearest, a tie away from zero at either
    sign (to even would keep 1 for 1 + 2^-11); the 13 low bits of big and of
    small are zero; big + small carries all but 2^-22 of x."""
    x = torch.tensor([1.0, 1 + 2 ** -11, -(1 + 2 ** -11), 1 + 2 ** -12, 1 + 3 * 2 ** -11, 2 ** -20 * (1 + 2 ** -11)])
    want = [1.0, 1 + 2 ** -10, -(1 + 2 ** -10), 1.0, 1 + 2 ** -9, 2 ** -20 * (1 + 2 ** -10)]
    assert round_to_tf32(x).tolist() == want
    y = torch.from_numpy(np.random.default_rng(0).normal(size=10_000).astype(np.float32))
    big, small = split_tf32(y)
    assert ((big.view(torch.int32) & 0x1FFF) == 0).all() and ((small.view(torch.int32) & 0x1FFF) == 0).all()
    assert ((y - big).abs() <= 2 ** -11 * y.abs()).all()
    assert ((y.double() - big.double() - small.double()).abs() <= 2 ** -22 * y.double().abs()).all()


def _errors(a: torch.Tensor, b: torch.Tensor):
    """Largest |result - float64| of a float32 matmul, the 3xTF32 split and a single TF32 product."""
    want = a.double() @ b.double()
    return [(got.double() - want).abs().max().item()
            for got in (a @ b, matmul_3xtf32(a, b), round_to_tf32(a) @ round_to_tf32(b))]


def _check_split(f32, split, tf32):
    assert split <= SPLIT_FACTOR * f32, (split, f32)
    assert tf32 >= TF32_FACTOR * split, (tf32, split)


@pytest.mark.parametrize("head_dim", HEAD_DIMS)
def test_split_scores_match_float64(head_dim):
    """S = q k^T scale over head_dim columns, as the kernels form S (and,
    with V and dO, dP): two heads of 336 rows, unit normals."""
    rng = np.random.default_rng(head_dim)
    q, k = (torch.from_numpy(rng.normal(size=(2, 336, head_dim)).astype(np.float32)) for _ in range(2))
    _check_split(*_errors(q * head_dim ** -0.5, k.transpose(-1, -2)))


@pytest.mark.parametrize("head_dim", HEAD_DIMS)
def test_split_slice_products_match_float64(head_dim):
    """dV = P^T dO over 336 queries, as the kernels form dV (and, with dS,
    dK and dQ): P a causal softmax of the scores of two heads."""
    rng = np.random.default_rng(head_dim + 1)
    q, k, do = (torch.from_numpy(rng.normal(size=(2, 336, head_dim)).astype(np.float32)) for _ in range(3))
    s = (q @ k.transpose(-1, -2)) * head_dim ** -0.5
    p = torch.softmax(s.masked_fill(~torch.ones(336, 336, dtype=torch.bool).tril(), float("-inf")), dim=-1)
    _check_split(*_errors(p.transpose(-1, -2).contiguous(), do))


# (name, batch, heads, seq, causal, left-padded keys, all-masked sample 0): rows 0..2 of the causal padded
# cases see no kept key (lse +inf, p 0), as every row of the empty sample does
CASES = [
    ("causal_padded_65", 2, 2, 65, True, True, False),
    ("causal_padded_empty_sample_77", 2, 2, 77, True, True, True),
    ("noncausal_padded_empty_sample_40", 2, 2, 40, False, True, True),
]
CASE_IDS = [f"{c[0]}_d{d}" for d in (64, 256) for c in CASES]
CASE_ARGS = [(*c, d) for d in (64, 256) for c in CASES]


def _inputs(b, h, t, padded, empty, d, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.normal(size=(b, h, t, d)).astype(np.float32) for _ in range(4))
    mask = np.ones((b, t), np.int32)
    if padded:
        mask[:, :3] = 0
        mask[-1, t // 2: t // 2 + 2] = 0
    if empty:
        mask[0, :] = 0
    return q, k, v, g, mask


def _emulated_and_plain(q, k, v, g, mask, causal):
    scale = q.shape[-1] ** -0.5
    t = [torch.from_numpy(x) for x in (q, k, v, mask, g)]
    o, lse = tattn.flash_forward_plain(t[0], t[1], t[2], t[3], causal, scale)
    emulated = flash_backward_3xtf32(t[0], t[1], t[2], t[3], o, lse, t[4], causal, scale)
    plain = tattn.flash_backward_plain(t[0], t[1], t[2], t[3], o, lse, t[4], causal, scale)
    return emulated, plain, o, lse


@pytest.mark.parametrize("name,b,h,t,causal,padded,empty,d", CASE_ARGS, ids=CASE_IDS)
def test_emulated_backward_matches_plain(name, b, h, t, causal, padded, empty, d):
    """Every product in 3xTF32 against every product in float32: dq, dk, dv
    within 1e-5; an empty row's gradients stay exactly 0 in both."""
    q, k, v, g, mask = _inputs(b, h, t, padded, empty, d)
    emulated, plain, _, _ = _emulated_and_plain(q, k, v, g, mask, causal)
    for label, x, y in zip(("dq", "dk", "dv"), emulated, plain):
        np.testing.assert_allclose(x.numpy(), y.numpy(), atol=PLAIN_ATOL, rtol=PLAIN_RTOL, err_msg=label)
    if empty:
        assert (emulated[0][0] == 0).all() and (emulated[1][0] == 0).all() and (emulated[2][0] == 0).all()


@pytest.mark.parametrize("name,b,h,t,causal,padded,empty,d", CASE_ARGS, ids=CASE_IDS)
def test_emulated_backward_matches_pallas(interpret_mode, name, b, h, t, causal, padded, empty, d):
    """The emulated 3xTF32 backward against the JAX package's Pallas dK/dV
    and dQ kernels (interpret mode, "always": exact float32 products at
    float32 inputs) from the same (o, lse), within the card's F32_ATOL."""
    q, k, v, g, mask = _inputs(b, h, t, padded, empty, d)
    emulated, _, o, lse = _emulated_and_plain(q, k, v, g, mask, causal)
    ref = jattn._flash_backward(
        *(jnp.asarray(x) for x in (q, k, v, mask, o.numpy(), lse.numpy(), g)),
        causal=causal, scale=d ** -0.5, block_q=64, block_k=64, use_mask=True,
    )
    for label, x, y in zip(("dq", "dk", "dv"), emulated, ref):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=F32_ATOL, rtol=F32_RTOL, err_msg=label)


FWD_CASE_IDS = [f"{c[0]}_d{d}" for d in HEAD_DIMS for c in CASES]
FWD_CASE_ARGS = [(*c, d) for d in HEAD_DIMS for c in CASES]


def _emulated_and_plain_forward(q, k, v, mask, causal):
    scale = q.shape[-1] ** -0.5
    t = [torch.from_numpy(x) for x in (q, k, v, mask)]
    return flash_forward_3xtf32(*t, causal, scale), tattn.flash_forward_plain(*t, causal, scale)


def _check_empty_rows(o, lse, want_lse):
    """lse +inf exactly where the reference's is, and o 0 on those rows."""
    inf = np.isinf(want_lse)
    np.testing.assert_array_equal(np.isinf(lse), inf)
    assert (o[inf] == 0).all()


@pytest.mark.parametrize("name,b,h,t,causal,padded,empty,d", FWD_CASE_ARGS, ids=FWD_CASE_IDS)
def test_emulated_forward_matches_plain(name, b, h, t, causal, padded, empty, d):
    """Both forward products in 3xTF32 against both in float32: o and lse
    within 1e-5; a row with no kept key has lse +inf and o 0 in both."""
    q, k, v, _, mask = _inputs(b, h, t, padded, empty, d)
    (o, lse), (o_p, lse_p) = _emulated_and_plain_forward(q, k, v, mask, causal)
    np.testing.assert_allclose(o.numpy(), o_p.numpy(), atol=PLAIN_ATOL, rtol=PLAIN_RTOL, err_msg="o")
    fin = np.isfinite(lse_p.numpy())
    np.testing.assert_allclose(lse.numpy()[fin], lse_p.numpy()[fin], atol=PLAIN_ATOL, rtol=PLAIN_RTOL, err_msg="lse")
    _check_empty_rows(o.numpy(), lse.numpy(), lse_p.numpy())
    assert (o_p.numpy()[~fin] == 0).all()


@pytest.mark.parametrize("name,b,h,t,causal,padded,empty,d", FWD_CASE_ARGS, ids=FWD_CASE_IDS)
def test_emulated_forward_matches_pallas(interpret_mode, name, b, h, t, causal, padded, empty, d):
    """The emulated 3xTF32 forward against the JAX package's Pallas forward
    (interpret mode, exact float32 products at float32 inputs), o and lse
    within the card's F32_ATOL, empty rows alike."""
    q, k, v, _, mask = _inputs(b, h, t, padded, empty, d)
    (o, lse), _ = _emulated_and_plain_forward(q, k, v, mask, causal)
    ref_o, ref_lse = (np.asarray(x) for x in jattn._flash_forward(
        *(jnp.asarray(x) for x in (q, k, v, mask)), causal=causal, scale=d ** -0.5, block_q=64, block_k=64,
        use_mask=True))
    np.testing.assert_allclose(o.numpy(), ref_o, atol=F32_ATOL, rtol=F32_RTOL, err_msg="o")
    fin = np.isfinite(ref_lse)
    np.testing.assert_allclose(lse.numpy()[fin], ref_lse[fin], atol=F32_ATOL, rtol=F32_RTOL, err_msg="lse")
    _check_empty_rows(o.numpy(), lse.numpy(), ref_lse)
