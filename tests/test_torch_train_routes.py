"""The port's other training routes against the JAX package: the
per-microbatch cadence under `MultiSteps` (3 x `make_train_step` + 1 x
`make_distill_step` at k = 4), `make_distill_step` alone, the MAFED window
unfused (`fuse_ce_batch=False`) and from uint8 pixels (the frozen tower run
once over the window's images), and the adaptive modality weights
(`make_adaptive_weights_fn`, through a zero hidden-state perturbation).

Same tiny model on both sides (tests/torch_helpers.py: hidden 128, 2 heads
of 64, 3 layers, a tower of 4 patches), parameters from the JAX
`init_params`, a teacher of other parameters held in bfloat16, the bench's
distill settings (balanced modality weights, discounted layers, gamma 0.5),
AdamW with weight decay and `set_schedule(..., 0, 100)`. JAX steps with
`attn_impl="xla"`.

Tolerances, float32: losses, grad norms and adaptive sums at rtol 1e-5;
parameters after the updates at atol 1e-6 / rtol 1e-5, as
tests/test_torch_window.py argues. bfloat16: rtol 3e-2.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from mafed_tpu.core.config import TrainConfig as JTrainConfig
from mafed_tpu.optim import optimizer as jopt
from mafed_tpu.training import step as jstep
from mafed_tpu.training.train_state import TrainState as JTrainState, split_params
from mafed_tpu_torch.core.config import TrainConfig as TTrainConfig
from mafed_tpu_torch.data.images import make_normalizer, prep_pixels
from mafed_tpu_torch.models import gpt_neox
from mafed_tpu_torch.models import vl_pythia as tvl
from mafed_tpu_torch.models.weights import params_from_jax
from mafed_tpu_torch.optim import optimizer as topt
from mafed_tpu_torch.training import step as tstep
from mafed_tpu_torch.training.train_state import TrainState, make_teacher, trainable_parameters
from tests.torch_helpers import batch, jax_params, stack, tiny_cfgs, to_jax, to_torch, torch_model

N_CE, B, TEXT = 3, 2, 16
LR = 5e-5


def _kw(compute_dtype="float32", **over):
    kw = dict(
        optim="adamw", weight_decay=0.01, replay_coeff=1.0, distillation_coeff=1.0,
        distillation_modality_weighing_strategy="balanced",
        distillation_layer_weighing_strategy="discounted", distillation_layer_discount=0.5,
        compute_dtype=compute_dtype, learning_rate=LR, label_tail=8,
    )
    kw.update(over)
    return kw


@pytest.fixture(scope="module")
def setup():
    jcfg, tc = tiny_cfgs()
    params = jax_params(jcfg, seed=6)
    teacher_params = jax_params(jcfg, seed=8)
    return jcfg, tc, params, teacher_params


def _batches(tc, pixels=False):
    ce = [batch(tc, B, TEXT, seed=60 + i, pad=1 + i, pixels=pixels) for i in range(N_CE)]
    return ce, batch(tc, B, TEXT, seed=70, pad=4, pixels=pixels)


def _jax_side(jcfg, params, teacher_params, kw, every_k=None):
    trainable, frozen = split_params(params)
    tx = jopt.build_optimizer(JTrainConfig(**kw), trainable)
    if every_k:
        tx = optax.MultiSteps(tx, every_k_schedule=every_k)
    state = JTrainState(jnp.zeros((), jnp.int32), trainable, frozen, jopt.set_schedule(tx.init(trainable), 0, 100))
    teacher = jax.tree.map(lambda x: x.astype(jnp.bfloat16), split_params(teacher_params)[0])
    lang = jnp.full((jcfg.num_hidden_layers - 1,), 0.5, jnp.float32)
    return tx, state, teacher, lang


def _torch_side(tc, params, teacher_params, kw, every_k=None):
    model = torch_model(params, tc)
    teacher = make_teacher(torch_model(teacher_params, tc))
    trainable = trainable_parameters(model)
    opt = topt.build_optimizer(TTrainConfig(**kw), trainable)
    if every_k:
        opt = topt.MultiSteps(opt, every_k)
    state = TrainState(0, model, topt.set_schedule(opt.init(trainable), 0, 100))
    return model, opt, state, teacher, torch.full((tc.num_hidden_layers - 1,), 0.5)


def _check_params(model, j_trainable, tc):
    j_sd = params_from_jax(jax.tree.map(np.asarray, j_trainable), tc)
    for name, p in trainable_parameters(model).items():
        np.testing.assert_allclose(p.detach().numpy(), j_sd[name].numpy(), atol=1e-6, rtol=1e-5, err_msg=name)


def _check_same_params(a, b):
    for (name, p), q in zip(trainable_parameters(a).items(), trainable_parameters(b).values()):
        np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(), atol=1e-6, rtol=1e-5, err_msg=name)


def _fused_window(tc, params, teacher_params, kw, ce, distill, **window_kw):
    model, opt, state, teacher, lang = _torch_side(tc, params, teacher_params, kw)
    step = tstep.make_mafed_window_step(tc, TTrainConfig(**kw), opt, n_ce=N_CE, device="cpu", **window_kw)
    _, m = step(state, teacher, to_torch(stack(ce)), to_torch(distill), lang)
    return model, m


def test_multisteps_cadence_matches_jax_and_the_fused_window(setup):
    """3 CE microbatch steps then 1 distill step under MultiSteps(k = 4),
    against the same cadence through optax.MultiSteps, and against the port's
    fused MAFED window on the same batches: one update of the same mean
    gradient."""
    jcfg, tc, params, teacher_params = setup
    kw = _kw(accumulate_grad_batches=N_CE + 1)
    ce, distill = _batches(tc)
    tx, jstate, jteacher, jlang = _jax_side(jcfg, params, teacher_params, kw, every_k=N_CE + 1)
    j_ce = jstep.make_train_step(jcfg, JTrainConfig(**kw), tx, attn_impl="xla", donate=False)
    j_d = jstep.make_distill_step(jcfg, JTrainConfig(**kw), tx, attn_impl="xla", donate=False)
    model, opt, state, teacher, lang = _torch_side(tc, params, teacher_params, kw, every_k=N_CE + 1)
    t_ce = tstep.make_train_step(tc, TTrainConfig(**kw), opt, device="cpu")
    t_d = tstep.make_distill_step(tc, TTrainConfig(**kw), opt, device="cpu")
    losses = []
    for mb in ce:
        jstate, jm = j_ce(jstate, to_jax(mb))
        state, tm = t_ce(state, to_torch(mb))
        losses.append(float(tm["loss"]))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
        assert float(tm["grad_norm"]) == float(jm["grad_norm"]) == 0.0  # no boundary yet
    jstate, jm = j_d(jstate, jteacher, to_jax(distill), jlang)
    state, tm = t_d(state, teacher, to_torch(distill), lang)
    losses.append(float(tm["loss"]))
    for key in ("loss", "grad_norm", "distill_layer_losses"):
        np.testing.assert_allclose(tm[key].numpy(), np.asarray(jm[key]), rtol=1e-5, atol=1e-7, err_msg=key)
    assert state.opt_state.gradient_step == 1 and state.opt_state.mini_step == 0
    _check_params(model, jstate.trainable, tc)

    fused, m = _fused_window(tc, params, teacher_params, _kw(), ce, distill)
    np.testing.assert_allclose(float(m["loss"]), np.mean(losses), rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), float(tm["grad_norm"]), rtol=1e-5)
    _check_same_params(model, fused)


def test_distill_step_matches_jax_f32(setup):
    """Two distill steps, each with its own update; the student is not
    recomputed in backward."""
    jcfg, tc, params, teacher_params = setup
    kw = _kw()
    _, distill = _batches(tc)
    tx, jstate, jteacher, jlang = _jax_side(jcfg, params, teacher_params, kw)
    j_d = jstep.make_distill_step(jcfg, JTrainConfig(**kw), tx, attn_impl="xla", donate=False)
    model, opt, state, teacher, lang = _torch_side(tc, params, teacher_params, kw)
    t_d = tstep.make_distill_step(tc, TTrainConfig(**kw), opt, device="cpu")
    for _ in range(2):
        jstate, jm = j_d(jstate, jteacher, to_jax(distill), jlang)
        state, tm = t_d(state, teacher, to_torch(distill), lang)
        for key in ("loss", "grad_norm", "distill_layer_losses"):
            np.testing.assert_allclose(tm[key].numpy(), np.asarray(jm[key]), rtol=1e-5, atol=1e-7, err_msg=key)
    _check_params(model, jstate.trainable, tc)


def _run_windows(jcfg, tc, params, teacher_params, kw, ce, distill, fuse, windows=2):
    tx, jstate, jteacher, jlang = _jax_side(jcfg, params, teacher_params, kw)
    jwin = jstep.make_mafed_window_step(jcfg, JTrainConfig(**kw), tx, n_ce=N_CE, attn_impl="xla", donate=False,
                                        fuse_ce_batch=fuse)
    model, opt, state, teacher, lang = _torch_side(tc, params, teacher_params, kw)
    twin = tstep.make_mafed_window_step(tc, TTrainConfig(**kw), opt, n_ce=N_CE, fuse_ce_batch=fuse, device="cpu")
    history = []
    for _ in range(windows):
        jstate, jm = jwin(jstate, jteacher, to_jax(stack(ce)), to_jax(distill), jlang)
        state, tm = twin(state, teacher, to_torch(stack(ce)), to_torch(distill), lang)
        for key in ("loss", "ce_loss", "distill_loss", "grad_norm", "distill_layer_losses"):
            np.testing.assert_allclose(tm[key].numpy(), np.asarray(jm[key]), rtol=1e-5, atol=1e-7, err_msg=key)
        history.append(tm)
    _check_params(model, jstate.trainable, tc)
    return model, history


def test_unfused_window_matches_jax_and_the_fused_window(setup):
    """fuse_ce_batch=False (one pass and one backward per CE microbatch)
    against the JAX package's lax.scan route, two windows; its first window
    against the port's fused window."""
    jcfg, tc, params, teacher_params = setup
    kw = _kw()
    ce, distill = _batches(tc)
    model, history = _run_windows(jcfg, tc, params, teacher_params, kw, ce, distill, fuse=False)
    fused, m = _fused_window(tc, params, teacher_params, kw, ce, distill)
    for key in ("loss", "ce_loss", "distill_loss", "grad_norm"):
        np.testing.assert_allclose(history[0][key].numpy(), m[key].numpy(), rtol=1e-5, err_msg=key)


@pytest.mark.parametrize("fuse", [True, False], ids=["shared_tower", "unfused"])
def test_pixels_window_matches_jax_and_the_cached_window(setup, fuse):
    """The window from uint8 pixels, two windows, against the JAX package
    (fused: the tower once over the window's 4 x B images); its first window
    against the port's cached window on the port's own tower features."""
    jcfg, tc, params, teacher_params = setup
    kw = _kw()
    ce, distill = _batches(tc, pixels=True)
    model, history = _run_windows(jcfg, tc, params, teacher_params, kw, ce, distill, fuse=fuse)
    start = torch_model(params, tc)
    normalize = make_normalizer(tc.vision)

    def cached(mb):
        with torch.no_grad():
            feats = tvl.get_patch_embeddings(start, prep_pixels(to_torch(mb), normalize, torch.float32),
                                             dtype=torch.float32)
        out = {k: v for k, v in mb.items() if k != "pixels"}
        out["patches"] = feats.numpy()
        return out

    _, m = _fused_window(tc, params, teacher_params, kw, [cached(mb) for mb in ce], cached(distill))
    for key in ("loss", "ce_loss", "distill_loss", "grad_norm"):
        np.testing.assert_allclose(history[0][key].numpy(), m[key].numpy(), rtol=1e-5, err_msg=key)


ADAPTIVE_CASES = {"patches_f32": (False, "float32"), "pixels_f32": (True, "float32"), "patches_bf16": (False, "bfloat16")}


@pytest.mark.parametrize("case", list(ADAPTIVE_CASES))
def test_adaptive_weights_match_jax(setup, case):
    """(lang_sums, image_sums, n_lang, n_img) over every distilled tap, against
    make_adaptive_weights_fn; the model is left without gradients."""
    pixels, dtype = ADAPTIVE_CASES[case]
    jcfg, tc, params, _ = setup
    kw = _kw(dtype)
    layers = jstep.distillation_layers("discounted", jcfg.num_hidden_layers - 1, None)
    mb = batch(tc, 3, TEXT, seed=80, pad=3, pixels=pixels)
    trainable, frozen = split_params(params)
    want = jstep.make_adaptive_weights_fn(jcfg, JTrainConfig(**kw), layers, attn_impl="xla")(trainable, frozen, to_jax(mb))
    model = torch_model(params, tc)
    got = tstep.make_adaptive_weights_fn(tc, TTrainConfig(**kw), layers, device="cpu")(model, to_torch(mb))
    rtol = 1e-5 if dtype == "float32" else 3e-2
    for name, g, w in zip(("lang_sums", "image_sums", "n_lang", "n_img"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=rtol, err_msg=name)
    assert got[0].shape == (len(layers),) and float(got[0].min()) > 0 and float(got[1].min()) > 0
    assert all(p.grad is None for p in model.parameters())


def test_zero_perturbation_is_the_plain_forward(setup):
    """A zero hidden_perturbation leaves the loss and the hidden states as
    they were; the perturbation is refused with a KV cache or an early exit."""
    _, tc, params, _ = setup
    model = torch_model(params, tc)
    mb = to_torch(batch(tc, 2, TEXT, seed=81))
    args = (model, mb["input_ids"], mb["attention_mask"], mb["labels"])
    kwargs = dict(patch_embeddings=mb["patches"], dtype=torch.float32, output_hidden_states=True)
    plain = tvl.forward(*args, **kwargs)
    t = tc.vision.num_patches + TEXT
    pert = torch.zeros((tc.num_hidden_layers, 2, t, tc.hidden_size))
    perturbed = tvl.forward(*args, hidden_perturbation=pert, **kwargs)
    assert torch.equal(plain.loss, perturbed.loss) and torch.equal(plain.hidden_states, perturbed.hidden_states)
    embeds = torch.zeros((2, t, tc.hidden_size))
    with pytest.raises(ValueError, match="plain forward path"):
        model.gpt_neox(embeds, num_layers=1, layer_perturbation=pert[1:], dtype=torch.float32)
    cache = gpt_neox.KVCache.create(tc, 2, t, dtype=torch.float32)
    with pytest.raises(ValueError, match="no-cache path"):
        model.gpt_neox(embeds, cache=cache, layer_perturbation=pert[1:], dtype=torch.float32)
