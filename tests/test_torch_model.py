"""Port decoder and VL-Pythia (mafed_tpu_torch/models) against the JAX package.

Same tiny model on both sides: parameters from the JAX `init_params`,
carried into the port by `params_from_jax`. The JAX decoder runs its Pallas
flash kernel in interpret mode. float32 is checked at atol 1e-5 / rtol 1e-4
(summation order only); bfloat16 at a relative norm error of 1e-2 per
hidden-state tap and rtol 2e-2 on the loss, since the two frameworks round
bf16 intermediates at different points (bias adds, GELU, matmul outputs), a
few bf16 ulps (1/128 relative) on single elements.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mafed_tpu.kernels import attention as jattn
from mafed_tpu.models import gpt_neox as jneox
from mafed_tpu.models import vl_pythia as jvl
from mafed_tpu.models.weights import params_to_reference_state_dict
from mafed_tpu_torch.kernels import attention as tattn
from mafed_tpu_torch.models import vl_pythia as tvl
from mafed_tpu_torch.models.weights import params_from_jax
from mafed_tpu_torch.training.train_state import trainable_parameters
from tests.torch_helpers import WIDE_DECODERS, WIDE_IDS, batch, jax_params, tiny_cfgs, to_jax, to_torch, torch_model

ATOL, RTOL = 1e-5, 1e-4


@pytest.fixture(autouse=True)
def interpret_mode():
    jattn._INTERPRET = True
    jattn._PALLAS_BWD_MODE = "always"
    yield
    jattn._INTERPRET = False
    jattn._PALLAS_BWD_MODE = "auto"


@pytest.fixture(scope="module")
def setup():
    jcfg, tc = tiny_cfgs()
    return jcfg, tc, jax_params(jcfg, seed=1)


@pytest.fixture(scope="module", params=list(WIDE_DECODERS), ids=WIDE_IDS)
def setup_wide(request):
    """The tiny model with 2 heads of 256 (the 1B decoder's), 128
    (Pythia-1.4B's) or 96 (GPT-NeoX-20B's), rotary over a quarter of them."""
    jcfg, tc = tiny_cfgs(decoder=WIDE_DECODERS[request.param])
    assert tc.head_dim == request.param and tc.rotary_ndims == request.param // 4
    return jcfg, tc, jax_params(jcfg, seed=1)


def test_params_from_jax_matches_reference_names(setup):
    _check_reference_names(setup)


def test_params_from_jax_matches_reference_names_wide_heads(setup_wide):
    _check_reference_names(setup_wide)


def _check_reference_names(setup):
    """Every entry of the JAX package's own export, the EVA-02 tower's
    `vision_encoder.*` included, is a port parameter under the same name with
    the same values (bf16 tower leaves compared in f32), and loads strictly."""
    jcfg, tc, params = setup
    params_np = jax.tree.map(np.asarray, params)
    sd = params_from_jax(params_np, tc)
    ref = params_to_reference_state_dict(params_np, jcfg)
    assert set(sd) == set(ref)
    assert set(sd) == set(tvl.VLPythia(tc, device="cpu").state_dict())
    assert any(k.startswith("vision_encoder.blocks.1.") for k in sd)
    for name, t in sd.items():
        np.testing.assert_array_equal(t.float().numpy(), ref[name].astype(np.float32), err_msg=name)
    # the trainable split (no `vision` subtree) carries no tower entries
    trainable = {k: v for k, v in params_np.items() if k != "vision"}
    assert set(params_from_jax(trainable, tc)) == {k for k in ref if not k.startswith("vision_encoder.")}


def test_params_from_jax_keeps_bf16(setup):
    jcfg, tc, params = setup
    params_bf16 = jax.tree.map(lambda x: np.asarray(x.astype(jnp.bfloat16)), params)
    sd = params_from_jax(params_bf16, tc)
    w = sd["gpt_neox.layers.1.attention.query_key_value.weight"]
    assert w.dtype == torch.bfloat16
    ref = np.asarray(params["decoder"]["layers"]["attention"]["query_key_value"]["weight"][1].astype(jnp.bfloat16))
    np.testing.assert_array_equal(w.float().numpy(), ref.astype(np.float32).T)


def _embeds(tc, seed=2):
    rng = np.random.default_rng(seed)
    b, t = 2, 20
    embeds = rng.normal(size=(b, t, tc.hidden_size)).astype(np.float32)
    mask = np.ones((b, t), np.int32)
    mask[0, :4] = 0
    return embeds, mask


@pytest.mark.parametrize("num_layers", [None, 2], ids=["full_stack", "truncated"])
def test_decoder_hidden_states_f32(setup, num_layers):
    _check_decoder_hidden_states(setup, num_layers)


@pytest.mark.parametrize("num_layers", [None, 1], ids=["full_stack", "truncated"])
def test_decoder_hidden_states_f32_wide_heads(setup_wide, num_layers):
    _check_decoder_hidden_states(setup_wide, num_layers)


def _check_decoder_hidden_states(setup, num_layers):
    jcfg, tc, params = setup
    embeds, mask = _embeds(tc)
    ref = jneox.apply(
        params["decoder"], jcfg, jnp.asarray(embeds), attention_mask=jnp.asarray(mask),
        output_hidden_states=True, dtype=jnp.float32, attn_impl="pallas", num_layers=num_layers,
    )
    model = torch_model(params, tc)
    with torch.no_grad():
        got = model.gpt_neox(
            torch.from_numpy(embeds), attention_mask=torch.from_numpy(mask),
            output_hidden_states=True, dtype=torch.float32, num_layers=num_layers,
        )
    depth = tc.num_hidden_layers if num_layers is None else num_layers
    assert got["hidden_states"].shape == (depth + 1, 2, 20, tc.hidden_size)
    np.testing.assert_allclose(got["hidden_states"].numpy(), np.asarray(ref["hidden_states"]), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got["last_hidden_state"].numpy(), np.asarray(ref["last_hidden_state"]), atol=ATOL, rtol=RTOL)
    if num_layers is not None:  # truncated: raw carry, no final LN
        np.testing.assert_array_equal(got["last_hidden_state"].numpy(), got["hidden_states"][-1].numpy())


def _forward_pair(setup, dtype_j, dtype_t, **kw):
    jcfg, tc, params = setup
    b_np = batch(tc, b=3, text_len=16, seed=4)
    jb, tb = to_jax(b_np), to_torch(b_np)
    ref = jvl.forward(
        params, jcfg, jb["input_ids"], None, jb["attention_mask"], jb["labels"],
        patch_embeddings=jb["patches"].astype(dtype_j), dtype=dtype_j, attn_impl="pallas", **kw,
    )
    model = torch_model(params, tc)
    with torch.no_grad():
        got = tvl.forward(
            model, tb["input_ids"], tb["attention_mask"], tb["labels"],
            patch_embeddings=tb["patches"].to(dtype_t), dtype=dtype_t, **kw,
        )
    return ref, got


@pytest.mark.parametrize("kw", [{}, {"loss_only": True}, {"loss_only": True, "label_tail": 6}], ids=["full_logits", "loss_only", "label_tail"])
def test_vl_pythia_loss_f32(setup, kw):
    ref, got = _forward_pair(setup, jnp.float32, torch.float32, **kw)
    assert got.logits.shape == ref.logits.shape
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(ref.logits), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got.loss.item(), float(ref.loss), atol=ATOL, rtol=RTOL)


def test_vl_pythia_loss_bf16(setup):
    ref, got = _forward_pair(setup, jnp.bfloat16, torch.bfloat16, loss_only=True, output_hidden_states=True)
    np.testing.assert_allclose(got.loss.item(), float(ref.loss), rtol=2e-2)
    got_hs = got.hidden_states.float().numpy()
    ref_hs = np.asarray(ref.hidden_states.astype(jnp.float32))
    for layer, (g, r) in enumerate(zip(got_hs, ref_hs)):
        assert np.linalg.norm(g - r) <= 1e-2 * np.linalg.norm(r), layer


def test_vl_pythia_grads_f32_with_remat(setup):
    _check_grads_with_remat(setup)


def test_vl_pythia_grads_f32_with_remat_wide_heads(setup_wide):
    _check_grads_with_remat(setup_wide)


def _check_grads_with_remat(setup):
    """Gradients of the loss w.r.t. every parameter, autograd through the
    flash autograd function and per-layer recompute, against jax.grad."""
    jcfg, tc, params = setup
    b_np = batch(tc, b=2, text_len=12, seed=6)
    jb, tb = to_jax(b_np), to_torch(b_np)

    def jloss(p):
        return jvl.forward(
            p, jcfg, jb["input_ids"], None, jb["attention_mask"], jb["labels"],
            patch_embeddings=jb["patches"], dtype=jnp.float32, attn_impl="pallas",
            loss_only=True, remat_layers=True,
        ).loss

    jgrads = params_from_jax(jax.tree.map(np.asarray, jax.grad(jloss)(params)), tc)
    model = torch_model(params, tc)
    tattn.reset_launches()
    loss = tvl.forward(
        model, tb["input_ids"], tb["attention_mask"], tb["labels"],
        patch_embeddings=tb["patches"], dtype=torch.float32, loss_only=True, remat_layers=True,
    ).loss
    loss.backward()
    assert tattn.LAUNCHES["flash_fwd"] == 0  # CPU tensors: plain versions, no kernel
    assert all(p.grad is None for p in model.vision_encoder.parameters())  # frozen
    for name, p in trainable_parameters(model).items():
        np.testing.assert_allclose(p.grad.numpy(), jgrads[name].numpy(), atol=1e-6, rtol=1e-4, err_msg=name)


def test_init_model_defaults_to_cuda():
    _, tc = tiny_cfgs()
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    with pytest.raises(RuntimeError, match="CUDA"):
        tvl.init_model(tc)
    model = tvl.init_model(tc, seed=0, device="cpu")
    assert next(model.parameters()).device.type == "cpu"
    # seeded: the same seed gives the same weights
    again = tvl.init_model(tc, seed=0, device="cpu")
    for (n, a), (_, b) in zip(model.state_dict().items(), again.state_dict().items()):
        assert torch.equal(a, b), n
