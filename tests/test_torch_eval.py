"""The port's evaluation path against the JAX package: the image normaliser,
the EVA-02 tower, VL-Pythia from pixels, the greedy KV-cache decoder, the
VQA-v2 metric and the validation loop.

Same tiny model on both sides (hidden 128, 2 heads of 64, 3 layers; a tower
of 16 patches + CLS, 2 heads of 64, 2 blocks, so both the tower and the
prefill take the flash dispatch), parameters from the JAX `init_params`
carried over by `params_from_jax`, inputs from numpy seeds. The JAX tower
runs its Pallas kernel in interpret mode; its decoder runs as its own tests
run it (`attn_impl="xla"`). float32 throughout. Tolerances: the rope table
is equal, the normaliser within 1e-6, tower features within atol = rtol =
1e-4 (summation order only), the loss within rtol 1e-5, greedy tokens and
validation results exactly equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mafed_tpu.core.config import VisionConfig as JVisionConfig
from mafed_tpu.data import images as jimages
from mafed_tpu.data.tokenizer import ByteTokenizer as JByteTokenizer
from mafed_tpu.evaluation import vqa_metrics as jmetrics
from mafed_tpu.evaluation.decode import make_greedy_decoder as jax_decoder
from mafed_tpu.evaluation.validate import validate_vqa as jax_validate
from mafed_tpu.kernels import attention as jattn
from mafed_tpu.models import eva02 as jeva
from mafed_tpu.models import vl_pythia as jvl
from mafed_tpu_torch.core.config import VisionConfig
from mafed_tpu_torch.data import images as timages
from mafed_tpu_torch.data.tokenizer import ByteTokenizer, build_tokenizer
from mafed_tpu_torch.evaluation import vqa_metrics as tmetrics
from mafed_tpu_torch.evaluation.decode import make_greedy_decoder
from mafed_tpu_torch.evaluation.validate import validate_vqa
from mafed_tpu_torch.kernels import attention as tattn
from mafed_tpu_torch.models import eva02 as teva
from mafed_tpu_torch.models import vl_pythia as tvl
from tests.torch_helpers import WIDE_DECODERS, WIDE_IDS, TINY_VISION_64, jax_params, tiny_cfgs, to_torch, torch_model

F32 = torch.float32


@pytest.fixture(autouse=True)
def interpret_mode():
    jattn._INTERPRET = True
    yield
    jattn._INTERPRET = False


@pytest.fixture(scope="module")
def setup():
    jcfg, tc = tiny_cfgs(TINY_VISION_64)
    params = jax_params(jcfg, seed=2)
    return jcfg, tc, params, torch_model(params, tc)


@pytest.fixture(scope="module", params=list(WIDE_DECODERS), ids=WIDE_IDS)
def setup_wide(request):
    """2 heads of 256 (the 1B decoder's), 128 or 96 behind the same head_dim-64 tower."""
    jcfg, tc = tiny_cfgs(TINY_VISION_64, decoder=WIDE_DECODERS[request.param])
    params = jax_params(jcfg, seed=2)
    return jcfg, tc, params, torch_model(params, tc)


def _decode_batch(cfg, b, text_len, seed, route="pixels"):
    """Left-padded text (rows padded by 0..3 positions) and uint8 NHWC pixels
    or cached patch features."""
    rng = np.random.default_rng(seed)
    out = {
        "input_ids": rng.integers(1, cfg.vocab_size - 1, size=(b, text_len)).astype(np.int32),
        "attention_mask": np.ones((b, text_len), np.int32),
    }
    for row in range(b):
        out["attention_mask"][row, : row % 4] = 0
    if route == "pixels":
        side = cfg.vision.img_size
        out["pixels"] = rng.integers(0, 256, size=(b, side, side, 3)).astype(np.uint8)
    else:
        out["patches"] = rng.normal(size=(b, cfg.vision.num_patches, cfg.vision.embed_dim)).astype(np.float32)
    return out


# --- (a) the rope table and the normaliser ------------------------------------

@pytest.mark.parametrize("ref_side", [None, 16])
def test_rope_table_equals_jax(ref_side):
    kw = dict(TINY_VISION_64, rope_ref_feat_side=ref_side)
    np.testing.assert_array_equal(teva.rope_embed_2d(VisionConfig(**kw)), jeva.rope_embed_2d(JVisionConfig(**kw)))
    # and at the full EVA-02-L width
    np.testing.assert_array_equal(teva.rope_embed_2d(VisionConfig()), jeva.rope_embed_2d(JVisionConfig()))


def test_interleaved_rotation_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 2, 16, 64)).astype(np.float32)
    emb = teva.rope_embed_2d(VisionConfig(**TINY_VISION_64))
    got = teva.apply_rot_embed_cat(torch.from_numpy(x), torch.from_numpy(emb))
    want = jeva.apply_rot_embed_cat(jnp.asarray(x), jnp.asarray(emb))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


def test_normalizer_matches_jax():
    cfg = VisionConfig(**TINY_VISION_64)
    pixels = np.stack([timages.synthetic_image(s, cfg) for s in range(3)])
    np.testing.assert_array_equal(pixels[1], jimages.synthetic_image(1, JVisionConfig(**TINY_VISION_64)))
    want = jimages.prep_pixels({"pixels": jnp.asarray(pixels)}, JVisionConfig(**TINY_VISION_64), jnp.float32)
    normalize = timages.make_normalizer(cfg)
    got = timages.prep_pixels({"pixels": torch.from_numpy(pixels)}, normalize, F32)
    assert got.shape == (3, 3, 56, 56)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)
    # float NCHW passes through, cast to the compute dtype
    floats = timages.prep_pixels({"pixels": got.double()}, normalize, F32)
    assert floats.dtype == F32 and torch.equal(floats, got)


# --- (b) the tower; (d) VL-Pythia from pixels ----------------------------------

def test_tower_forward_features_matches_jax():
    jcfg, tc = tiny_cfgs(TINY_VISION_64)
    params = jax_params(jcfg, seed=5, vision_dtype=jnp.float32)
    model = torch_model(params, tc)
    pixels = np.random.default_rng(5).normal(size=(2, 3, 56, 56)).astype(np.float32)
    want = jeva.forward_features(params["vision"], jcfg.vision, jnp.asarray(pixels), dtype=jnp.float32, attn_impl="pallas")
    with torch.no_grad():
        got = model.vision_encoder.forward_features(torch.from_numpy(pixels), dtype=F32)
    assert got.shape == (2, 17, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


def test_forward_from_pixels_matches_jax(setup):
    jcfg, tc, params, model = setup
    b_np = _decode_batch(tc, 3, 12, seed=6)
    labels = b_np["input_ids"].copy()
    labels[:, :-4] = -100
    pixels = np.asarray(jimages.prep_pixels({"pixels": jnp.asarray(b_np["pixels"])}, jcfg.vision, jnp.float32))
    ref = jvl.forward(
        params, jcfg, jnp.asarray(b_np["input_ids"]), jnp.asarray(pixels), jnp.asarray(b_np["attention_mask"]),
        jnp.asarray(labels), dtype=jnp.float32, attn_impl="pallas",
    )
    tb = to_torch({**b_np, "labels": labels})
    with torch.no_grad():
        got = tvl.forward(model, tb["input_ids"], tb["attention_mask"], tb["labels"],
                          pixel_values=torch.from_numpy(pixels.copy()), dtype=F32)
    assert tvl.n_vision_tokens(tc) == jvl.n_vision_tokens(jcfg) == 16
    np.testing.assert_allclose(got.loss.item(), float(ref.loss), rtol=1e-5)


# --- (e) greedy tokens against JAX; (f) against the port's recompute loop ------

def _jax_tokens(jcfg, params, b_np, max_new, eos=0):
    dec = jax_decoder(jcfg, max_new_tokens=max_new, eos_token_id=eos, dtype=jnp.float32, attn_impl="xla")
    return np.asarray(dec(params, {k: jnp.asarray(v) for k, v in b_np.items()}))


def _port_tokens(tc, model, b_np, max_new, eos=0):
    dec = make_greedy_decoder(tc, max_new_tokens=max_new, eos_token_id=eos, dtype=F32, device="cpu")
    toks = dec(model, to_torch(b_np))
    assert toks.dtype == torch.int32 and toks.shape == (b_np["input_ids"].shape[0], max_new)
    return toks.numpy()


DECODE_CASES = [("pixels", 6, 0), ("pixels", 10, 1), ("patches", 6, 1), ("patches", 10, 0)]


@pytest.mark.parametrize("route,max_new,seed", DECODE_CASES)
def test_greedy_tokens_equal_jax(setup, route, max_new, seed):
    jcfg, tc, params, model = setup
    b_np = _decode_batch(tc, 4, 8, seed=seed, route=route)
    want = _jax_tokens(jcfg, params, b_np, max_new)
    np.testing.assert_array_equal(_port_tokens(tc, model, b_np, max_new), want)


@pytest.mark.parametrize("route", ["pixels", "patches"])
def test_greedy_tokens_equal_jax_wide_heads(setup_wide, route):
    """The wider heads: a KV cache of [B, 2, T, head_dim], rotary over a
    quarter of them; 10 tokens (bench_eval.py's count) from each route."""
    jcfg, tc, params, model = setup_wide
    b_np = _decode_batch(tc, 4, 8, seed=7, route=route)
    want = _jax_tokens(jcfg, params, b_np, 10)
    got = _port_tokens(tc, model, b_np, 10)
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got)) > 1  # not a degenerate row of one token


def test_forced_eos_tokens_equal_jax(setup):
    """EOS = the token row 0 emits at step 2: that row turns to EOS from step
    2 on, on both sides, and rows that never emit it are untouched."""
    jcfg, tc, params, model = setup
    b_np = _decode_batch(tc, 4, 8, seed=3)
    free = _port_tokens(tc, model, b_np, 10)
    eos = int(free[0, 2])
    want = _jax_tokens(jcfg, params, b_np, 10, eos=eos)
    got = _port_tokens(tc, model, b_np, 10, eos=eos)
    np.testing.assert_array_equal(got, want)
    assert (got[0, 2:] == eos).all()


def _recompute_greedy(tc, model, b_np, max_new, eos=0):
    """The reference's use_cache=False loop: the whole forward for every token."""
    tb = to_torch(b_np)
    ids, mask = tb["input_ids"], tb["attention_mask"]
    pixels = timages.prep_pixels(tb, timages.make_normalizer(tc.vision), F32)
    finished = torch.zeros(ids.shape[0], dtype=torch.bool)
    out = []
    with torch.no_grad():
        for _ in range(max_new):
            logits = tvl.forward(model, ids, mask, pixel_values=pixels, dtype=F32).logits[:, -1]
            tok = torch.where(finished, eos, logits.argmax(-1)).to(torch.int32)
            out.append(tok)
            finished |= tok == eos
            ids = torch.cat([ids, tok[:, None]], dim=1)
            mask = torch.cat([mask, torch.ones_like(mask[:, :1])], dim=1)
    return torch.stack(out, dim=1).numpy()


def test_cached_decode_equals_recompute(setup):
    _, tc, _, model = setup
    b_np = _decode_batch(tc, 4, 8, seed=4)
    np.testing.assert_array_equal(_port_tokens(tc, model, b_np, 6), _recompute_greedy(tc, model, b_np, 6))


# --- (g) which calls go through the flash forward -------------------------------

@pytest.mark.parametrize("route", ["pixels", "patches"])
def test_flash_forward_calls_per_decode(setup, monkeypatch, route):
    _check_flash_forward_calls(setup, monkeypatch, route)


@pytest.mark.parametrize("route", ["pixels", "patches"])
def test_flash_forward_calls_per_decode_wide_heads(setup_wide, monkeypatch, route):
    _check_flash_forward_calls(setup_wide, monkeypatch, route)


def _check_flash_forward_calls(setup, monkeypatch, route):
    """The tower (one call per block, heads of 64) and the prefill (one per
    layer, the decoder's heads) go through the flash forward; the
    single-token steps do not."""
    _, tc, _, model = setup
    calls = []
    real = tattn.flash_forward

    def spy(q, k, v, mask, causal, scale):
        calls.append((tuple(q.shape), causal, mask is not None))
        return real(q, k, v, mask, causal, scale)

    monkeypatch.setattr(tattn, "flash_forward", spy)
    _port_tokens(tc, model, _decode_batch(tc, 2, 8, seed=0, route=route), 5)
    vis, dec = tc.vision.depth, tc.num_hidden_layers
    tower = [((2, 2, 17, 64), False, False)] * vis if route == "pixels" else []
    assert calls == tower + [((2, tc.num_attention_heads, 16 + 8, tc.head_dim), True, True)] * dec


# --- (h) the VQA-v2 metric ------------------------------------------------------

ANSWERS = [
    "Two dogs.", "the red one", "It's a cat!", "dont know", "yes", "no, not really", "10,000", "3.5",
    "an apple", "a/b test", "  Three  ", "ten", "none", "whats that", "Im here", "1,2", "left-hand", "(none)",
]


def test_vqa_metric_matches_jax():
    for a in ANSWERS:
        assert tmetrics.normalize_answer(a) == jmetrics.normalize_answer(a), a
    for n in range(5):
        assert tmetrics.vqa_v2_score(n) == jmetrics.vqa_v2_score(n)
    gts = [[jmetrics.normalize_answer(x) for x in ANSWERS[i : i + 3]] * 2 for i in range(len(ANSWERS) - 2)]
    preds = ANSWERS[1:-1]
    tm, jm = tmetrics.VQAGenerativeAccuracy(), jmetrics.VQAGenerativeAccuracy()
    tm(preds, gts)
    jm(preds, gts)
    assert (tm.accuracy, tm.total) == (jm.accuracy, jm.total) and tm.compute() == jm.compute() > 0


def test_byte_tokenizer_matches_jax():
    t, j = ByteTokenizer(), JByteTokenizer()
    for text in ANSWERS:
        assert t(text).input_ids == j(text).input_ids
    rows = [[0, 73, 300, 101, 256, 1], [5, 0, 0]]
    assert t.batch_decode(rows) == j.batch_decode(rows)
    assert isinstance(build_tokenizer("no/such/dir", allow_fallback=True), ByteTokenizer)
    with pytest.raises(RuntimeError, match="unavailable"):
        build_tokenizer("no/such/dir")


# --- (i) the validation loop ----------------------------------------------------

def test_validate_vqa_matches_jax(setup):
    """Three batches of 4, the last one short (3 rows, padded by repeating its
    last row); answers are some rows' own predictions, so accuracy is neither
    0 nor 1."""
    jcfg, tc, params, model = setup
    tok = ByteTokenizer()
    batches = [_decode_batch(tc, n, 8, seed=20 + i) for i, n in enumerate((4, 4, 3))]
    port_dec = make_greedy_decoder(tc, max_new_tokens=6, dtype=F32, device="cpu")
    for i, batch in enumerate(batches):
        preds = tok.batch_decode(port_dec(model, to_torch(batch)).numpy())
        batch["answers"] = [[tmetrics.normalize_answer(p)] * (1 + j) if j % 2 == 0 else ["x"] * 3
                            for j, p in enumerate(preds)]
        batch["qids"] = [f"q{i}_{j}" for j in range(len(preds))]
    log, results = validate_vqa(model, port_dec, batches, tok, batch_size=4)
    jdec = jax_decoder(jcfg, max_new_tokens=6, eos_token_id=0, dtype=jnp.float32, attn_impl="xla")
    jlog, jresults = jax_validate(params, jdec, batches, JByteTokenizer(), batch_size=4)
    assert results == jresults and len(results) == 11
    assert log["valid/n_ex"] == jlog["valid/n_ex"] == 11
    assert log["valid/acc"] == jlog["valid/acc"]
    assert 0 < log["valid/acc"] < 1 and log["valid/ex_per_s"] > 0


# --- (j) the entry points run on the card unless asked for the CPU --------------

def test_decoder_defaults_to_cuda():
    _, tc = tiny_cfgs()
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_greedy_decoder(tc)
    make_greedy_decoder(tc, device="cpu")


def test_tower_is_frozen_bf16_and_shared_with_the_teacher():
    from mafed_tpu_torch.training.train_state import make_teacher, trainable_parameters

    _, tc = tiny_cfgs(TINY_VISION_64)
    model = tvl.init_model(tc, seed=0, device="cpu", dtype=F32)
    tower = list(model.vision_encoder.parameters())
    assert all(p.dtype == torch.bfloat16 and not p.requires_grad for p in tower)
    assert model.embed_out.weight.dtype == F32
    assert not any(name.startswith("vision_encoder.") for name in trainable_parameters(model))
    teacher = make_teacher(model)
    assert teacher.vision_encoder is model.vision_encoder
    assert teacher.embed_out.weight.dtype == torch.bfloat16 and model.embed_out.weight.dtype == F32
