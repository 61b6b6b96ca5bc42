"""The port's fused MAFED window (mafed_tpu_torch/training/step.py) and
optimizer against the JAX package's `make_mafed_window_step` and optax chain.

Same tiny model, same parameters, same batches (3 CE microbatches + 1 memory
microbatch with cached patches), the bench's distill settings (balanced
modality weights, discounted layers, gamma 0.5), AdamW with weight decay,
`set_schedule(..., 0, 100)` on both sides so the first update has a non-zero
learning rate.

Tolerances, float32 compute:
  * losses and the grad norm: rtol 1e-5 (summation order only);
  * parameters: atol 1e-6 after two updates of lr 5e-5. Adam divides the
    first moment by sqrt(nu), so where a gradient is at rounding-noise level
    the direction can differ by up to the full step (~lr) without any real
    disagreement; 1e-6 is 2% of one step, and rtol 1e-5 covers the rest.
bfloat16 compute checks the losses at rtol 3e-2 (bf16 intermediates are
rounded at different points in the two frameworks).
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
from mafed_tpu_torch.models.weights import params_from_jax
from mafed_tpu_torch.optim import optimizer as topt
from mafed_tpu_torch.optim.sched import linear_warmup_schedule
from mafed_tpu_torch.training import step as tstep
from mafed_tpu_torch.training.train_state import TrainState, make_teacher, trainable_parameters
from tests.torch_helpers import WIDE_DECODERS, WIDE_IDS, batch, jax_params, tiny_cfgs, to_torch, torch_model

N_CE, B, TEXT = 3, 2, 16
LR = 5e-5


def _train_kwargs(compute_dtype, mu_dtype, **distill):
    kw = dict(
        optim="adamw", weight_decay=0.01, adam_mu_dtype=mu_dtype,
        replay_coeff=1.0, distillation_coeff=1.0,
        distillation_modality_weighing_strategy="balanced",
        distillation_layer_weighing_strategy="discounted",
        distillation_layer_discount=0.5, compute_dtype=compute_dtype,
        learning_rate=LR, label_tail=8,
    )
    kw.update(distill)
    return kw


def _batches(tc):
    ce = [batch(tc, B, TEXT, seed=10 + i, pad=2 + i) for i in range(N_CE)]
    ce_stack = {k: np.stack([c[k] for c in ce]) for k in ce[0]}
    return ce_stack, batch(tc, B, TEXT, seed=20, pad=5)


def _run_jax(jcfg, params, kw, ce_stack, distill, windows):
    train_cfg = JTrainConfig(**kw)
    trainable, frozen = split_params(params)
    teacher = jax.tree.map(lambda x: x.astype(jnp.bfloat16), trainable)
    tx = jopt.build_optimizer(train_cfg, trainable)
    opt_state = jopt.set_schedule(tx.init(trainable), 0, 100)
    state = JTrainState(jnp.zeros((), jnp.int32), trainable, frozen, opt_state)
    step = jstep.make_mafed_window_step(jcfg, train_cfg, tx, n_ce=N_CE, donate=False)
    lang = jnp.full((jcfg.num_hidden_layers - 1,), 0.5, jnp.float32)
    ce_j = {k: jnp.asarray(v) for k, v in ce_stack.items()}
    d_j = {k: jnp.asarray(v) for k, v in distill.items()}
    history = []
    for _ in range(windows):
        state, metrics = step(state, teacher, ce_j, d_j, lang)
        history.append({k: np.asarray(v) for k, v in metrics.items()})
    return state.trainable, history


def _run_torch(tc, params, kw, ce_stack, distill, windows):
    train_cfg = TTrainConfig(**kw)
    model = torch_model(params, tc)
    teacher = make_teacher(model)
    trainable = trainable_parameters(model)
    opt = topt.build_optimizer(train_cfg, trainable)
    state = TrainState(0, model, topt.set_schedule(opt.init(trainable), 0, 100))
    step = tstep.make_mafed_window_step(tc, train_cfg, opt, n_ce=N_CE, device="cpu")
    lang = torch.full((tc.num_hidden_layers - 1,), 0.5)
    history = []
    for _ in range(windows):
        state, metrics = step(state, teacher, to_torch(ce_stack), to_torch(distill), lang)
        history.append({k: v.numpy() for k, v in metrics.items()})
    return model, history


@pytest.fixture(scope="module")
def setup():
    jcfg, tc = tiny_cfgs()
    params = jax_params(jcfg, seed=3)
    return jcfg, tc, params, _batches(tc)


@pytest.fixture(scope="module", params=list(WIDE_DECODERS), ids=WIDE_IDS)
def setup_wide(request):
    """The tiny model with 2 heads of 256 (the 1B decoder's), 128 or 96."""
    jcfg, tc = tiny_cfgs(decoder=WIDE_DECODERS[request.param])
    params = jax_params(jcfg, seed=3)
    return jcfg, tc, params, _batches(tc)


# the bench's settings, then the other distillation branches of make_distill_loss_fn
WINDOW_CASES = {
    "bench_mu_f32": dict(mu_dtype=None),
    "bench_mu_bf16": dict(mu_dtype="bfloat16"),
    "equal_cosine": dict(mu_dtype=None, distillation_modality_weighing_strategy="equal",
                         distillation_layer_weighing_strategy="equal", distillation_loss="cosine"),
    "single_layer": dict(mu_dtype=None, distillation_layer_weighing_strategy="single", distillation_layer=1),
    "cls_token": dict(mu_dtype=None, cls_distillation=True),
}


@pytest.mark.parametrize("case", list(WINDOW_CASES))
def test_window_matches_jax_f32(setup, case):
    _check_window_f32(setup, WINDOW_CASES[case])


@pytest.mark.parametrize("case", ["bench_mu_f32", "bench_mu_bf16"])
def test_window_matches_jax_f32_wide_heads(setup_wide, case):
    """The window of the 1B run (the bench's settings) at the tiny width, with heads of 256, 128 or 96."""
    _check_window_f32(setup_wide, WINDOW_CASES[case])


def _check_window_f32(setup, train_kw):
    jcfg, tc, params, (ce_stack, distill) = setup
    kw = _train_kwargs("float32", **train_kw)
    j_trainable, j_hist = _run_jax(jcfg, params, kw, ce_stack, distill, windows=2)
    model, t_hist = _run_torch(tc, params, kw, ce_stack, distill, windows=2)
    for jm, tm in zip(j_hist, t_hist):
        for key in ("loss", "ce_loss", "distill_loss", "grad_norm", "distill_layer_losses"):
            np.testing.assert_allclose(tm[key], jm[key], rtol=1e-5, atol=1e-7, err_msg=key)
    j_sd = params_from_jax(jax.tree.map(np.asarray, j_trainable), tc)
    moved = 0
    init_sd = params_from_jax(jax.tree.map(np.asarray, params), tc)
    for name, p in trainable_parameters(model).items():
        np.testing.assert_allclose(p.detach().numpy(), j_sd[name].numpy(), atol=1e-6, rtol=1e-5, err_msg=name)
        moved += int(not torch.equal(p, init_sd[name]))
    assert moved == len(j_sd)  # every trainable tensor took the update
    for name, p in model.vision_encoder.state_dict().items():  # the frozen tower did not move
        assert torch.equal(p, init_sd["vision_encoder." + name]), name


def test_window_matches_jax_bf16(setup):
    jcfg, tc, params, (ce_stack, distill) = setup
    kw = _train_kwargs("bfloat16", "bfloat16")
    _, j_hist = _run_jax(jcfg, params, kw, ce_stack, distill, windows=1)
    _, t_hist = _run_torch(tc, params, kw, ce_stack, distill, windows=1)
    for key in ("loss", "ce_loss", "distill_loss", "grad_norm"):
        np.testing.assert_allclose(t_hist[0][key], j_hist[0][key], rtol=3e-2, err_msg=key)


def test_first_update_is_zero_without_a_horizon(setup):
    """ScheduleState starts at count 0, warmup 1: learning rate 0 until
    set_schedule, as in the JAX package."""
    _, tc, params, (ce_stack, distill) = setup
    train_cfg = TTrainConfig(**_train_kwargs("float32", None))
    model = torch_model(params, tc)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    trainable = trainable_parameters(model)
    opt = topt.build_optimizer(train_cfg, trainable)
    step = tstep.make_mafed_window_step(tc, train_cfg, opt, n_ce=N_CE, device="cpu")
    state, _ = step(TrainState(0, model, opt.init(trainable)), make_teacher(model),
                    to_torch(ce_stack), to_torch(distill), torch.full((2,), 0.5))
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert state.opt_state.schedule.count == 1


def test_merge_window_is_batch_major():
    x = np.arange(3 * 2 * 5).reshape(3, 2, 5)
    got = tstep._merge_window(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jstep._merge_window(jnp.asarray(x))))


@pytest.mark.parametrize("strategy,gamma,n", [("single", 0.9, 1), ("equal", 0.9, 4), ("discounted", 0.5, 23)])
def test_layer_coefficients_match(strategy, gamma, n):
    np.testing.assert_array_equal(tstep.layer_coefficients(strategy, gamma, n), jstep.layer_coefficients(strategy, gamma, n))
    if strategy != "single":
        assert tstep.distillation_layers(strategy, n, None) == jstep.distillation_layers(strategy, n, None)


@pytest.mark.parametrize("kind", ["mse", "cosine"])
def test_masked_token_loss_matches(kind):
    rng = np.random.default_rng(0)
    h, hp = (rng.normal(size=(3, 2, 9, 16)).astype(np.float32) for _ in range(2))
    mask = np.ones((2, 5), np.int32)
    mask[0, :2] = 0
    lang_j, img_j = jstep.modality_masks(jnp.asarray(mask), 4)
    lang_t, img_t = tstep.modality_masks(torch.from_numpy(mask), 4)
    np.testing.assert_array_equal(lang_t.numpy(), np.asarray(lang_j))
    np.testing.assert_array_equal(img_t.numpy(), np.asarray(img_j))
    want = jstep._masked_token_loss(jnp.asarray(h), jnp.asarray(hp), lang_j[None], kind)
    got = tstep._masked_token_loss(torch.from_numpy(h), torch.from_numpy(hp), lang_t[None], kind)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def _opt_case(rng, names_shapes):
    params = {n: rng.normal(size=s).astype(np.float32) * 0.1 for n, s in names_shapes}
    grads = [{n: rng.normal(size=s).astype(np.float32) for n, s in names_shapes} for _ in range(3)]
    return params, grads


@pytest.mark.parametrize("optim,mu_dtype,grad_norm,schedule", [
    ("adamw", None, 2.0, False), ("adamw", "bfloat16", 2.0, False), ("adamw", None, 1e3, False),
    ("adam", None, 2.0, False), ("adamw", None, 2.0, True),
], ids=["adamw", "adamw_mu_bf16", "adamw_unclipped", "adam_l2", "schedule_callable"])
def test_optimizer_matches_optax(optim, mu_dtype, grad_norm, schedule):
    """Three updates of the port's optimizer against the JAX package's optax
    chain on the same parameters and gradients. float32: rtol 1e-6, and atol
    1e-7, a millionth of the largest step (lr x lr_mul = 0.1), since the two
    round the step's f32 arithmetic in different orders."""
    names_shapes = [
        ("gpt_neox.layers.0.attention.dense.weight", (8, 8)),
        ("gpt_neox.layers.0.attention.dense.bias", (8,)),
        ("gpt_neox.layers.0.input_layernorm.weight", (8,)),
        ("vqa_output.weight", (4, 8)),
    ]
    rng = np.random.default_rng(1)
    params, grads = _opt_case(rng, names_shapes)
    kw = dict(optim=optim, adam_mu_dtype=mu_dtype, grad_norm=grad_norm, weight_decay=0.05, learning_rate=1e-2, lr_mul=10.0)

    j_params = {n: jnp.asarray(p) for n, p in params.items()}
    t_params = {n: torch.from_numpy(p.copy()) for n, p in params.items()}
    if schedule:  # the closure form: lr 1e-2 * step / 2 for two steps, then decaying
        from mafed_tpu.optim.sched import linear_warmup_schedule as jsched

        tx = jopt.build_optimizer(JTrainConfig(**kw), j_params, jsched(1e-2, 2, 10))
        j_state = tx.init(j_params)
        opt = topt.build_optimizer(TTrainConfig(**kw), t_params, linear_warmup_schedule(1e-2, 2, 10))
        t_state = opt.init(t_params)
    else:
        tx = jopt.build_optimizer(JTrainConfig(**kw), j_params)
        j_state = jopt.set_schedule(tx.init(j_params), 1, 10)
        opt = topt.build_optimizer(TTrainConfig(**kw), t_params)
        t_state = topt.set_schedule(opt.init(t_params), 1, 10)
    for g in grads:
        updates, j_state = tx.update({n: jnp.asarray(x) for n, x in g.items()}, j_state, j_params)
        j_params = optax.apply_updates(j_params, updates)
        t_state = opt.update(t_params, {n: torch.from_numpy(x) for n, x in g.items()}, t_state)
        np.testing.assert_allclose(float(topt.last_grad_norm(t_state)), float(jopt.last_grad_norm(j_state)), rtol=1e-6)
        for n in params:
            np.testing.assert_allclose(t_params[n].numpy(), np.asarray(j_params[n]), rtol=1e-6, atol=1e-7, err_msg=n)


def test_linear_warmup_schedule_matches():
    from mafed_tpu.optim.sched import linear_warmup_schedule as jsched

    for step in (0, 3, 10, 50, 200):
        np.testing.assert_allclose(
            float(linear_warmup_schedule(5e-5, 10, 100)(step)), float(jsched(5e-5, 10, 100)(step)), rtol=1e-6
        )


def test_window_step_defaults_to_cuda():
    _, tc = tiny_cfgs()
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    train_cfg = TTrainConfig(**_train_kwargs("float32", None))
    with pytest.raises(RuntimeError, match="CUDA"):
        tstep.make_mafed_window_step(tc, train_cfg, None, n_ce=N_CE)
