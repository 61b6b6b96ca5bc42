"""The port's CLIP tower (models/clip_vit.py) and VL-Pythia with it against
the JAX package (mafed_tpu/models/clip_vit.py, vl_pythia.forward and the
greedy decoder, attn_impl="xla") and against HF's CLIPVisionModel.

The JAX package's init_params always builds an EVA-02 tower, so its CLIP
model is the EVA-02 model with a CLIP tree put in by hand, as
tests/test_clip_vit_parity.py does; both sides get that tree.

Tolerances, float32: hidden states atol = rtol = 1e-4 (summation order
through LayerNorm, as the EVA-02 tower's test); logits and loss 1e-5
relative; greedy tokens equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mafed_tpu.core.config import ModelConfig as JModelConfig, VisionConfig as JVisionConfig
from mafed_tpu.data import images as jimages
from mafed_tpu.evaluation.decode import make_greedy_decoder as jax_decoder
from mafed_tpu.models import clip_vit as jclip
from mafed_tpu.models import vl_pythia as jvl

from mafed_tpu_torch.core import config as tcfg
from mafed_tpu_torch.evaluation.decode import make_greedy_decoder
from mafed_tpu_torch.kernels import attention as tattn
from mafed_tpu_torch.models import clip_vit as tclip
from mafed_tpu_torch.models import vl_pythia as tvl
from tests.torch_helpers import TINY, to_torch, torch_model

F32 = torch.float32
# heads of 64, so that attention at >= 8 tokens takes the flash dispatch
CLIP_TINY = dict(backbone="clip", patch_size=14, embed_dim=128, depth=2, num_heads=2, mlp_ratio=2.0)


def _cfgs(img_size=42, select_feature="patch"):
    vis = dict(CLIP_TINY, img_size=img_size)
    jcfg = JModelConfig(**TINY, vision=JVisionConfig(**vis), select_layer=-2, select_feature=select_feature)
    tc = tcfg.ModelConfig(**TINY, vision=tcfg.VisionConfig(**vis), select_layer=-2, select_feature=select_feature)
    return jcfg, tc


def _params(jcfg, seed=0):
    params = jvl.init_params(jcfg, jax.random.PRNGKey(seed), dtype=jnp.float32)
    params["vision"] = jclip.init_params(jcfg.vision, jax.random.PRNGKey(seed + 1))  # float32
    return params


@pytest.fixture(scope="module")
def setup():
    jcfg, tc = _cfgs()
    params = _params(jcfg, seed=4)
    return jcfg, tc, params, torch_model(params, tc)


@pytest.mark.parametrize("img_size, tokens", [(42, 10), (28, 5)], ids=["10_tokens", "5_tokens"])
def test_tower_matches_jax(img_size, tokens):
    """10 tokens take the flash dispatch (its plain version here); 5, below
    its 8-query floor, the masked path."""
    jcfg, tc = _cfgs(img_size)
    params = _params(jcfg, seed=2)
    model = torch_model(params, tc)
    pixels = np.random.default_rng(1).normal(size=(3, 3, img_size, img_size)).astype(np.float32)
    want = np.asarray(jclip.forward_hidden_states(params["vision"], jcfg.vision, jnp.asarray(pixels),
                                                  dtype=jnp.float32, attn_impl="xla"))
    with torch.no_grad():
        got = model.vision_encoder.forward_hidden_states(torch.from_numpy(pixels), dtype=F32)
    assert got.shape == want.shape == (tc.vision.depth + 1, 3, tokens, 128)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


def test_tower_matches_hf():
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    hf = transformers.CLIPVisionModel(transformers.CLIPVisionConfig(
        hidden_size=128, intermediate_size=256, num_hidden_layers=2, num_attention_heads=2, image_size=42,
        patch_size=14, attn_implementation="eager")).eval()
    tower = tclip.CLIPVisionModel(tcfg.VisionConfig(**CLIP_TINY, img_size=42), device="cpu")
    missing, unexpected = tower.load_state_dict(hf.state_dict(), strict=False)
    assert missing == [] and set(unexpected) <= {"vision_model.embeddings.position_ids"}
    pixels = torch.from_numpy(np.random.default_rng(0).normal(size=(2, 3, 42, 42)).astype(np.float32))
    with torch.no_grad():
        want = hf(pixels, output_hidden_states=True).hidden_states
        got = tower.hidden_states(pixels, dtype=F32)
    assert len(got) == len(want) == 3
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-4, rtol=1e-4, err_msg=f"hidden state {i}")


def test_tower_attention_takes_the_flash_forward(setup, monkeypatch):
    _, tc, _, model = setup
    calls = []
    real = tattn.flash_forward

    def spy(q, k, v, mask, causal, scale):
        calls.append((tuple(q.shape), causal, mask, scale))
        return real(q, k, v, mask, causal, scale)

    monkeypatch.setattr(tattn, "flash_forward", spy)
    with torch.no_grad():
        model.vision_encoder.hidden_states(torch.zeros(2, 3, 42, 42), dtype=F32)
    assert calls == [((2, 2, 10, 64), False, None, 64 ** -0.5)] * tc.vision.depth


def _batch(cfg, b, text_len, seed):
    rng = np.random.default_rng(seed)
    mask = np.ones((b, text_len), np.int32)
    for row in range(b):
        mask[row, : row % 3] = 0
    side = cfg.vision.img_size
    return {"input_ids": rng.integers(1, cfg.vocab_size - 1, size=(b, text_len)).astype(np.int32),
            "attention_mask": mask, "pixels": rng.integers(0, 256, size=(b, side, side, 3)).astype(np.uint8)}


def test_vl_pythia_logits_match_jax(setup):
    jcfg, tc, params, model = setup
    b_np = _batch(tc, 3, 8, seed=3)
    labels = b_np["input_ids"].copy()
    labels[:, :-3] = -100
    pixels = np.asarray(jimages.prep_pixels({"pixels": jnp.asarray(b_np["pixels"])}, jcfg.vision, jnp.float32))
    ref = jvl.forward(params, jcfg, jnp.asarray(b_np["input_ids"]), jnp.asarray(pixels),
                      jnp.asarray(b_np["attention_mask"]), jnp.asarray(labels), dtype=jnp.float32, attn_impl="xla")
    tb = to_torch({**b_np, "labels": labels})
    with torch.no_grad():
        got = tvl.forward(model, tb["input_ids"], tb["attention_mask"], tb["labels"],
                          pixel_values=torch.from_numpy(pixels.copy()), dtype=F32)
    assert tvl.n_vision_tokens(tc) == jvl.n_vision_tokens(jcfg) == 9
    assert got.logits.shape == (3, 9 + 8, tc.vocab_size)
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(ref.logits), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.loss.item(), float(ref.loss), rtol=1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_greedy_tokens_equal_jax(setup, seed):
    jcfg, tc, params, model = setup
    b_np = _batch(tc, 4, 8, seed=seed)
    jdec = jax_decoder(jcfg, max_new_tokens=6, eos_token_id=0, dtype=jnp.float32, attn_impl="xla")
    want = np.asarray(jdec(params, {k: jnp.asarray(v) for k, v in b_np.items()}))
    got = make_greedy_decoder(tc, max_new_tokens=6, eos_token_id=0, dtype=F32, device="cpu")(model, to_torch(b_np))
    np.testing.assert_array_equal(got.numpy(), want)


def test_select_layer_and_cls_patch():
    """get_patch_embeddings takes hidden_states[select_layer]; "cls_patch" keeps the CLS token."""
    jcfg, tc = _cfgs(select_feature="cls_patch")
    params = _params(jcfg, seed=6)
    model = torch_model(params, tc)
    pixels = torch.from_numpy(np.random.default_rng(2).normal(size=(2, 3, 42, 42)).astype(np.float32))
    with torch.no_grad():
        feats = tvl.get_patch_embeddings(model, pixels, dtype=F32)
        hs = model.vision_encoder.hidden_states(pixels, dtype=F32)
    assert feats.shape == (2, tvl.n_vision_tokens(tc), 128) and tvl.n_vision_tokens(tc) == 10
    assert torch.equal(feats, hs[-2])
    want = np.asarray(jvl.get_patch_embeddings(params, jcfg, jnp.asarray(pixels.numpy()), dtype=jnp.float32,
                                               attn_impl="xla"))
    np.testing.assert_allclose(feats.numpy(), want, atol=1e-4, rtol=1e-4)


def test_init_weights_as_the_jax_package():
    """normal(0, 0.02) projections and embeddings, zero biases, unit LayerNorm scales."""
    _, tc = _cfgs()
    model = tvl.init_model(tc, seed=0, device="cpu")
    tower = model.vision_encoder
    assert isinstance(tower, tclip.CLIPVisionModel) and tower.cfg.backbone == "clip"
    assert all(p.dtype == torch.bfloat16 and not p.requires_grad for p in tower.parameters())
    sd = {k: v.float() for k, v in tower.state_dict().items()}
    weights = torch.cat([sd[k].flatten() for k in sd if k.endswith("proj.weight") or ".fc" in k and "weight" in k])
    assert abs(weights.std().item() - 0.02) < 2e-3 and abs(weights.mean().item()) < 2e-3
    assert all((sd[k] == 0).all() for k in sd if k.endswith(".bias"))
    assert all((sd[k] == 1).all() for k in sd if "norm" in k and k.endswith(".weight"))
