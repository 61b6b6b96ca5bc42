"""Port attention (mafed_tpu_torch/kernels/attention.py) against the JAX
package's Pallas flash kernels, run in interpret mode on the CPU.

The port's dense plain versions are what its wrappers run on CPU tensors and
what the CUDA kernels are held against on the card: the bfloat16 kernels,
and at float32 inputs (a `--compute_dtype float32` run) the float32 ones.
Here they are held against `_flash_forward` / `_flash_backward` in float32,
as those kernels take it, with atol 1e-5,
rtol 1e-4: both sum f32 products, in different orders (online softmax over
64-key tiles against one dense softmax), so they differ by float32 rounding
only. Both forwards are also held, at the same tolerance, against a float64
dense softmax in numpy, so a disagreement names the side that moved. Every
case runs at the head_dim of its name (64; 96, GPT-NeoX-20B's heads; 128,
Pythia-1.4B's; 256, the 1B decoder's; 384 and 512, the regrouped decoders'
that the wide kernels take, and 640) with the models' scale head_dim^-0.5.

The JAX references are compiled in this module's process, never read from
the persistent compilation cache (`tests/conftest.py` turns it on for the
suite): an executable from that cache may have been compiled by another
process, on another machine type.

Torch runs on one CPU thread here (`one_torch_thread`). In parallel runs of
the suite, a multithreaded CPU matmul of the port's plain forward returned,
rarely, up to 5e-5 off in the block of rows a second thread computes when
the product is split two ways (rows 33-64 of one head of a 65-row case;
every other value bit-equal to a clean recompute), which no global torch
setting (matmul precision, oneDNN mode, thread count) reproduces; on one
thread no product is split among threads.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax._src import compilation_cache

from mafed_tpu.kernels import attention as jattn
from mafed_tpu_torch.kernels import attention as tattn
from tests.torch_helpers import one_torch_thread  # noqa: F401 (a fixture)

ATOL, RTOL = 1e-5, 1e-4


@pytest.fixture(scope="module", autouse=True)
def no_persistent_cache():
    """The persistent compilation cache off for this module, and the
    in-memory executables dropped, so every JAX reference is compiled here;
    both restored afterwards."""
    was = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    compilation_cache.reset_cache()
    jax.clear_caches()
    yield
    jax.config.update("jax_enable_compilation_cache", was)
    compilation_cache.reset_cache()


@pytest.fixture(autouse=True)
def interpret_mode():
    jattn._INTERPRET = True
    jattn._PALLAS_BWD_MODE = "always"
    yield
    jattn._INTERPRET = False
    jattn._PALLAS_BWD_MODE = "auto"


# (name, batch, heads, q_len, kv_len, causal, masked, all-masked sample 0,
# head_dim); 65 and 129 sit one row past the CUDA kernels' 64-row tile edges,
# and 100 x 257 has query and key lengths that differ
CASES = [
    ("causal_padded", 2, 2, 64, 64, True, True, False, 64),
    ("noncausal_unmasked", 2, 2, 48, 48, False, False, False, 64),
    ("causal_unaligned_20", 2, 2, 20, 20, True, True, False, 64),
    ("noncausal_unaligned_200", 1, 2, 200, 200, False, True, False, 64),
    ("noncausal_empty_rows", 2, 2, 40, 40, False, True, True, 64),
    ("causal_tile_edge_65", 2, 2, 65, 65, True, True, False, 64),
    ("causal_tile_edge_129", 1, 2, 129, 129, True, True, False, 64),
    ("noncausal_100x257", 1, 2, 100, 257, False, True, False, 64),
    ("causal_padded_d256", 2, 2, 64, 64, True, True, False, 256),
    ("causal_tile_edge_65_d256", 2, 2, 65, 65, True, True, False, 256),
    ("causal_tile_edge_129_d256", 1, 2, 129, 129, True, True, False, 256),
    ("noncausal_100x257_d256", 1, 2, 100, 257, False, True, False, 256),
    ("noncausal_empty_rows_d256", 2, 2, 40, 40, False, True, True, 256),
    ("causal_unaligned_20_d256", 2, 2, 20, 20, True, True, False, 256),
    ("causal_padded_d128", 2, 2, 64, 64, True, True, False, 128),
    ("causal_tile_edge_65_d128", 2, 2, 65, 65, True, True, False, 128),
    ("noncausal_empty_rows_d128", 2, 2, 40, 40, False, True, True, 128),
    ("noncausal_100x257_d128", 1, 2, 100, 257, False, True, False, 128),
    ("causal_padded_d96", 2, 2, 64, 64, True, True, False, 96),
    ("causal_tile_edge_65_d96", 2, 2, 65, 65, True, True, False, 96),
    ("noncausal_empty_rows_d96", 2, 2, 40, 40, False, True, True, 96),
    ("noncausal_100x257_d96", 1, 2, 100, 257, False, True, False, 96),
    ("causal_tile_edge_129_d96", 1, 2, 129, 129, True, True, False, 96),
    # the wide kernels' head_dims: 384 and 512 (the regrouped decoders), 640 (five 128-column slices)
    ("causal_padded_d384", 2, 2, 64, 64, True, True, False, 384),
    ("causal_tile_edge_65_d384", 2, 2, 65, 65, True, True, False, 384),
    ("noncausal_100x257_d384", 1, 2, 100, 257, False, True, False, 384),
    ("causal_padded_d512", 2, 2, 64, 64, True, True, False, 512),
    ("causal_tile_edge_65_d512", 2, 2, 65, 65, True, True, False, 512),
    ("noncausal_100x257_d512", 1, 2, 100, 257, False, True, False, 512),
    ("noncausal_empty_rows_d512", 2, 2, 40, 40, False, True, True, 512),
    ("causal_unaligned_20_d512", 2, 2, 20, 20, True, True, False, 512),
    ("causal_tile_edge_65_d640", 1, 2, 65, 65, True, True, False, 640),
]
CASE_ARGS = "name,b,h,t,kv_len,causal,masked,empty,d"


def _inputs(b, h, t, masked, empty, seed=0, kv_len=None, d=64):
    rng = np.random.default_rng(seed)
    kv_len = t if kv_len is None else kv_len
    q, k, v, g = (rng.normal(size=(b, h, n, d)).astype(np.float32) for n in (t, kv_len, kv_len, t))
    mask = np.ones((b, kv_len), np.int32)
    if masked:
        mask[:, :3] = 0  # left padding: causal rows 0..2 see no valid key
        mask[-1, kv_len // 2 : kv_len // 2 + 2] = 0
    if empty:
        mask[0, :] = 0  # every query row of sample 0 is empty
    return q, k, v, g, mask


def _scale(q):
    return q.shape[-1] ** -0.5


def _jax_fwd(q, k, v, mask, causal, masked):
    o, lse = jattn._flash_forward(
        *(jnp.asarray(x) for x in (q, k, v, mask)),
        causal=causal, scale=_scale(q), block_q=64, block_k=64, use_mask=masked,
    )
    return np.asarray(o), np.asarray(lse)


def _t(x):
    return torch.from_numpy(np.array(x))


def _assert_lse(got, want):
    got = got.numpy()
    inf = np.isinf(want)
    np.testing.assert_array_equal(np.isinf(got), inf)
    np.testing.assert_allclose(got[~inf], want[~inf], atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize(CASE_ARGS, CASES, ids=[c[0] for c in CASES])
def test_plain_forward_matches_pallas(name, b, h, t, kv_len, causal, masked, empty, d):
    q, k, v, _, mask = _inputs(b, h, t, masked, empty, kv_len=kv_len, d=d)
    o_ref, lse_ref = _jax_fwd(q, k, v, mask, causal, masked)
    o, lse = tattn.flash_forward_plain(_t(q), _t(k), _t(v), _t(mask) if masked else None, causal, _scale(q))
    np.testing.assert_allclose(o.numpy(), o_ref, atol=ATOL, rtol=RTOL)
    _assert_lse(lse, lse_ref)
    if causal and masked:
        assert np.isinf(lse_ref[:, :, :3]).all() and (o_ref[:, :, :3] == 0).all()
    if empty:
        assert np.isinf(lse_ref[0]).all() and (o_ref[0] == 0).all()


def _dense_f64(q, k, v, mask, causal):
    """o of the masked softmax in float64 numpy; rows with no valid key give 0."""
    q, k, v = (x.astype(np.float64) for x in (q, k, v))
    keep = np.ones((1, 1, q.shape[2], k.shape[2]), bool)
    if causal:
        keep = keep & np.tril(keep[0, 0])
    if mask is not None:
        keep = keep & (mask > 0)[:, None, None, :]
    s = np.where(keep, np.einsum("bhqd,bhkd->bhqk", q, k) * q.shape[-1] ** -0.5, -np.inf)
    m = s.max(axis=-1, keepdims=True)
    p = np.exp(s - np.where(np.isfinite(m), m, 0.0)) * keep
    l = p.sum(axis=-1, keepdims=True)
    return np.einsum("bhqk,bhkd->bhqd", p, v) / np.where(l == 0.0, 1.0, l)


@pytest.mark.parametrize(CASE_ARGS, CASES, ids=[c[0] for c in CASES])
def test_both_forwards_match_float64(name, b, h, t, kv_len, causal, masked, empty, d):
    q, k, v, _, mask = _inputs(b, h, t, masked, empty, kv_len=kv_len, d=d)
    want = _dense_f64(q, k, v, mask if masked else None, causal)
    o_jax, _ = _jax_fwd(q, k, v, mask, causal, masked)
    o_port, _ = tattn.flash_forward_plain(_t(q), _t(k), _t(v), _t(mask) if masked else None, causal, _scale(q))
    np.testing.assert_allclose(o_jax, want, atol=ATOL, rtol=RTOL, err_msg="Pallas (interpret) vs float64")
    np.testing.assert_allclose(o_port.numpy(), want, atol=ATOL, rtol=RTOL, err_msg="port plain vs float64")


def test_references_bypass_the_persistent_cache(monkeypatch):
    """A JAX reference compiled in this module neither reads nor writes the
    persistent compilation cache."""
    assert not compilation_cache.is_persistent_cache_enabled()
    used = []
    for name in ("get_executable_and_time", "put_executable_and_time"):
        monkeypatch.setattr(compilation_cache, name, lambda *a, _name=name, **k: used.append(_name))
    q, k, v, _, mask = _inputs(1, 3, 72, True, False, seed=9)  # a shape no other test compiles
    _jax_fwd(q, k, v, mask, True, True)
    assert used == []


@pytest.mark.parametrize(CASE_ARGS, CASES, ids=[c[0] for c in CASES])
def test_plain_backward_matches_pallas(name, b, h, t, kv_len, causal, masked, empty, d):
    q, k, v, g, mask = _inputs(b, h, t, masked, empty, kv_len=kv_len, d=d)
    o, lse = _jax_fwd(q, k, v, mask, causal, masked)
    ref = jattn._flash_backward(
        *(jnp.asarray(x) for x in (q, k, v, mask, o, lse, g)),
        causal=causal, scale=_scale(q), block_q=64, block_k=64, use_mask=masked,
    )
    got = tattn.flash_backward_plain(
        _t(q), _t(k), _t(v), _t(mask) if masked else None, _t(o), _t(lse), _t(g), causal, _scale(q)
    )
    for name_, x, y in zip(("dq", "dk", "dv"), got, ref):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=ATOL, rtol=RTOL, err_msg=name_)


@pytest.mark.parametrize("causal", [True, False])
def test_autograd_matches_dense_softmax(causal):
    """FlashAttention's gradients (plain backward from the saved o, lse)
    against autograd through the independent dense masked softmax, on rows
    that have at least one valid key."""
    q, k, v, g, mask = _inputs(2, 2, 40, True, False, seed=3)
    valid = np.ones((2, 1, 40, 1), np.float32)
    if causal:
        valid[:, :, :3] = 0.0  # empty rows: o is 0 in flash, uniform in the dense softmax
    g = g * valid

    def grads(fn):
        qt, kt, vt = (_t(x).requires_grad_(True) for x in (q, k, v))
        (fn(qt, kt, vt) * _t(g)).sum().backward()
        return qt.grad, kt.grad, vt.grad

    flash = grads(lambda a, b_, c: tattn.dot_product_attention(a, b_, c, key_padding_mask=_t(mask), causal=causal))
    dense = grads(lambda a, b_, c: tattn.masked_attention(a, b_, c, key_padding_mask=_t(mask), causal=causal))
    for x, y in zip(flash, dense):
        np.testing.assert_allclose(x.numpy(), y.numpy(), atol=ATOL, rtol=RTOL)


def test_autograd_uses_saved_residuals():
    q, k, v, g, mask = _inputs(1, 2, 24, True, False, seed=5)
    qt, kt, vt = (_t(x).requires_grad_(True) for x in (q, k, v))
    o = tattn.FlashAttention.apply(qt, kt, vt, _t(mask), True, 0.125)
    (o * _t(g)).sum().backward()
    o_p, lse_p = tattn.flash_forward_plain(_t(q), _t(k), _t(v), _t(mask), True, 0.125)
    want = tattn.flash_backward_plain(_t(q), _t(k), _t(v), _t(mask), o_p, lse_p, _t(g), True, 0.125)
    for x, y in zip((qt.grad, kt.grad, vt.grad), want):
        torch.testing.assert_close(x, y, atol=0, rtol=0)


def test_decode_offset_matches_xla_attention():
    """A causal_offset call (KV-cache decode) takes the plain masked path,
    the counterpart of xla_attention."""
    rng = np.random.default_rng(7)
    q = rng.normal(size=(2, 2, 1, 64)).astype(np.float32)
    k, v = (rng.normal(size=(2, 2, 10, 64)).astype(np.float32) for _ in range(2))
    mask = np.ones((2, 10), np.int32)
    mask[0, :2] = 0
    ref = jattn.xla_attention(
        *(jnp.asarray(x) for x in (q, k, v)), key_padding_mask=jnp.asarray(mask),
        causal=True, causal_offset=6,
    )
    got = tattn.dot_product_attention(_t(q), _t(k), _t(v), key_padding_mask=_t(mask), causal=True, causal_offset=6)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


def test_unsupported_head_dim_takes_plain_path_on_cpu():
    rng = np.random.default_rng(8)
    q, k, v = (rng.normal(size=(1, 2, 12, 16)).astype(np.float32) for _ in range(3))
    ref = jattn.xla_attention(*(jnp.asarray(x) for x in (q, k, v)), causal=True)
    tattn.reset_launches()
    got = tattn.dot_product_attention(_t(q), _t(k), _t(v), causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)
    assert tattn.LAUNCHES == {"flash_fwd": 0, "flash_bwd_dkv": 0, "flash_bwd_dq": 0}


# shapes that the JAX dispatcher sends to xla_attention even where it runs
# Pallas: head_dim 80 (Pythia-2.8B's heads), q_len under 8, causal with
# kv_len != q_len; (q shape, kv_len, causal)
XLA_SHAPES = [((2, 4, 24, 80), 24, True), ((2, 4, 4, 64), 4, False), ((2, 4, 24, 128), 40, True)]


@pytest.mark.parametrize("q_shape,kv_len,causal", XLA_SHAPES, ids=["head_dim_80", "q_len_4", "causal_24x40"])
def test_shapes_jax_sends_to_xla_take_masked_attention(q_shape, kv_len, causal, monkeypatch):
    """Both dispatchers route these shapes to their plain masked path (the
    JAX one with its Pallas kernels on, in interpret mode): the same result;
    the port never reaches FlashAttention and counts no flash launch."""
    b, h, t, d = q_shape
    rng = np.random.default_rng(10)
    q = rng.normal(size=q_shape).astype(np.float32)
    k, v = (rng.normal(size=(b, h, kv_len, d)).astype(np.float32) for _ in range(2))
    mask = np.ones((b, kv_len), np.int32)
    mask[0, :2] = 0
    ref = jattn.dot_product_attention(*(jnp.asarray(x) for x in (q, k, v)), key_padding_mask=jnp.asarray(mask),
                                      causal=causal)
    monkeypatch.setattr(tattn.FlashAttention, "apply", lambda *a: pytest.fail("took the flash path"))
    tattn.reset_launches()
    got = tattn.dot_product_attention(_t(q), _t(k), _t(v), key_padding_mask=_t(mask), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)
    assert tattn.LAUNCHES == {"flash_fwd": 0, "flash_bwd_dkv": 0, "flash_bwd_dq": 0}


def test_kernel_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers launch a kernel or raise; they never compute on the CPU."""
    x = torch.zeros(1, 1, 64, 64, dtype=torch.bfloat16)
    lse = torch.zeros(1, 1, 64)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tattn._flash_forward_cuda(x, x, x, None, True, 0.125)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tattn._flash_backward_cuda(x, x, x, None, x, lse, x, True, 0.125)
