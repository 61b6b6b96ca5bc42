"""The port's CE steps and optimizer wrappers against the JAX package:
`make_ce_window_step`, `make_train_step`, Adamax, `MultiSteps`, the remat
policy rule, the FLOPs counts, and the device rule of every new factory.

Same tiny model and parameters on both sides (hidden 128, 2 heads of 64, 3
layers; parameters from the JAX `init_params` carried over by
`params_from_jax`), batches from numpy seeds, the JAX steps with
`attn_impl="xla"` and `set_schedule(..., 0, 100)` on both sides so the first
update has a non-zero learning rate.

Tolerances, float32 compute: losses and the grad norm at rtol 1e-5;
parameters after two updates at atol 1e-6 / rtol 1e-5 (as
tests/test_torch_window.py argues: Adam turns rounding noise in a near-zero
gradient into up to one step of lr 5e-5, and 1e-6 is 2 % of it). bfloat16
compute: losses at rtol 3e-2. The optimizers alone: rtol 1e-6 / atol 1e-7,
as test_optimizer_matches_optax.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from mafed_tpu.core.config import TrainConfig as JTrainConfig
from mafed_tpu.optim import optimizer as jopt
from mafed_tpu.training import flops as jflops
from mafed_tpu.training import step as jstep
from mafed_tpu.training.train_state import TrainState as JTrainState, split_params
from mafed_tpu_torch.core.config import TrainConfig as TTrainConfig
from mafed_tpu_torch.models.gpt_neox import RematPolicy
from mafed_tpu_torch.models.weights import params_from_jax
from mafed_tpu_torch.optim import optimizer as topt
from mafed_tpu_torch.training import flops as tflops
from mafed_tpu_torch.training import step as tstep
from mafed_tpu_torch.training.train_state import TrainState, trainable_parameters
from tests.torch_helpers import WIDE_DECODERS, WIDE_IDS, batch, jax_params, stack, tiny_cfgs, to_torch, torch_model

N_MB, B, TEXT = 4, 2, 16
LR = 5e-5


def _kw(compute_dtype="float32", **over):
    kw = dict(optim="adamw", weight_decay=0.01, learning_rate=LR, label_tail=8, compute_dtype=compute_dtype)
    kw.update(over)
    return kw


@pytest.fixture(scope="module")
def setup():
    jcfg, tc = tiny_cfgs()
    params = jax_params(jcfg, seed=4)
    mbs = [batch(tc, B, TEXT, seed=30 + i, pad=1 + i) for i in range(N_MB)]
    return jcfg, tc, params, mbs


@pytest.fixture(scope="module", params=list(WIDE_DECODERS), ids=WIDE_IDS)
def setup_wide(request):
    """The tiny model with 2 heads of 256 (the 1B decoder's), 128 or 96."""
    jcfg, tc = tiny_cfgs(decoder=WIDE_DECODERS[request.param])
    params = jax_params(jcfg, seed=4)
    mbs = [batch(tc, B, TEXT, seed=30 + i, pad=1 + i) for i in range(N_MB)]
    return jcfg, tc, params, mbs


def _jax_state(params, train_cfg):
    trainable, frozen = split_params(params)
    tx = jopt.build_optimizer(train_cfg, trainable)
    return tx, JTrainState(jnp.zeros((), jnp.int32), trainable, frozen, jopt.set_schedule(tx.init(trainable), 0, 100))


def _torch_state(params, tc, train_cfg):
    model = torch_model(params, tc)
    trainable = trainable_parameters(model)
    opt = topt.build_optimizer(train_cfg, trainable)
    return model, opt, TrainState(0, model, topt.set_schedule(opt.init(trainable), 0, 100))


def _check_params(model, j_trainable, tc, params, adamax_nus=()):
    """Parameters at atol 1e-6 / rtol 1e-5. Given `adamax_nus` (the port's
    infinity moments after each update), elements whose gradient was below
    1e-7 in some update (nu < 1e-7, within 10x of Adamax's eps 1e-8) are held
    only to the bound of two Adamax steps on each side (4 lr): there
    g / (|g| + 1e-8) turns the f32 rounding noise of the two frameworks'
    gradients (~1e-9) into a sizeable part of a step. Most of them are the
    attention's key biases, whose gradient is zero up to rounding (softmax
    does not see a shift that is the same for every key)."""
    j_sd = params_from_jax(jax.tree.map(np.asarray, j_trainable), tc)
    init_sd = params_from_jax(jax.tree.map(np.asarray, params), tc)
    moved = 0
    for name, p in trainable_parameters(model).items():
        got, want = p.detach().numpy(), j_sd[name].numpy()
        if adamax_nus:
            quiet = np.any([nu[name].numpy() < 1e-7 for nu in adamax_nus], axis=0)
            np.testing.assert_array_less(np.abs(got - want)[quiet], 4 * LR)
            got, want = got[~quiet], want[~quiet]
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-5, err_msg=name)
        moved += int(not torch.equal(p, init_sd[name]))
    assert moved == len(j_sd)  # every trainable tensor took the update


CE_WINDOW_CASES = {
    "naive_adamw": {},
    "adamax_l2": dict(optim="adamax", weight_decay=0.05),
}


@pytest.mark.parametrize("case", list(CE_WINDOW_CASES))
def test_ce_window_matches_jax_f32(setup, case):
    _check_ce_window_f32(setup, CE_WINDOW_CASES[case])


def test_ce_window_matches_jax_f32_wide_heads(setup_wide):
    """The CE window of the 1B run (heads of 256, or 128, 96; AdamW with a bf16 first
    moment as the bench runs it) at the tiny width."""
    _check_ce_window_f32(setup_wide, dict(adam_mu_dtype="bfloat16"))


def _check_ce_window_f32(setup, train_kw):
    jcfg, tc, params, mbs = setup
    kw = _kw(**train_kw)
    windows = [stack(mbs), stack(mbs[::-1])]
    tx, jstate = _jax_state(params, JTrainConfig(**kw))
    jwin = jstep.make_ce_window_step(jcfg, JTrainConfig(**kw), tx, attn_impl="xla", donate=False)
    model, opt, state = _torch_state(params, tc, TTrainConfig(**kw))
    twin = tstep.make_ce_window_step(tc, TTrainConfig(**kw), opt, device="cpu")
    nus = []
    for w in windows:
        jstate, jm = jwin(jstate, {k: jnp.asarray(v) for k, v in w.items()})
        state, tm = twin(state, to_torch(w))
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(tm[key].numpy(), np.asarray(jm[key]), rtol=1e-5, err_msg=key)
        if kw["optim"] == "adamax":
            nus.append({k: v.clone() for k, v in state.opt_state.adam.nu.items()})
    _check_params(model, jstate.trainable, tc, params, nus)
    assert state.step == 2


def test_ce_window_matches_jax_bf16(setup):
    jcfg, tc, params, mbs = setup
    kw = _kw("bfloat16")
    tx, jstate = _jax_state(params, JTrainConfig(**kw))
    _, jm = jstep.make_ce_window_step(jcfg, JTrainConfig(**kw), tx, attn_impl="xla", donate=False)(
        jstate, {k: jnp.asarray(v) for k, v in stack(mbs).items()})
    _, opt, state = _torch_state(params, tc, TTrainConfig(**kw))
    _, tm = tstep.make_ce_window_step(tc, TTrainConfig(**kw), opt, device="cpu")(state, to_torch(stack(mbs)))
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=3e-2, err_msg=key)


@pytest.mark.parametrize("remat", [False, True], ids=["saved_o_lse", "remat"])
def test_train_step_matches_jax_f32(setup, remat):
    """Two microbatch steps, each with its own update (no accumulation)."""
    jcfg, tc, params, mbs = setup
    kw = _kw(remat=remat)
    tx, jstate = _jax_state(params, JTrainConfig(**kw))
    jtrain = jstep.make_train_step(jcfg, JTrainConfig(**kw), tx, attn_impl="xla", donate=False)
    model, opt, state = _torch_state(params, tc, TTrainConfig(**kw))
    ttrain = tstep.make_train_step(tc, TTrainConfig(**kw), opt, device="cpu")
    for mb in mbs[:2]:
        jstate, jm = jtrain(jstate, {k: jnp.asarray(v) for k, v in mb.items()})
        state, tm = ttrain(state, to_torch(mb))
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(tm[key].numpy(), np.asarray(jm[key]), rtol=1e-5, err_msg=key)
    _check_params(model, jstate.trainable, tc, params)
    assert all(p.grad is None for p in model.parameters())


NAMES_SHAPES = [
    ("gpt_neox.layers.0.attention.dense.weight", (8, 8)),
    ("gpt_neox.layers.0.attention.dense.bias", (8,)),
    ("gpt_neox.layers.0.input_layernorm.weight", (8,)),
    ("vqa_output.weight", (4, 8)),
]


def _opt_case(seed, n_grads):
    rng = np.random.default_rng(seed)
    params = {n: rng.normal(size=s).astype(np.float32) * 0.1 for n, s in NAMES_SHAPES}
    grads = [{n: rng.normal(size=s).astype(np.float32) for n, s in NAMES_SHAPES} for _ in range(n_grads)]
    grads[1]["gpt_neox.layers.0.attention.dense.bias"][:] = 0.0  # |g| + eps against a decayed nu
    return params, grads


@pytest.mark.parametrize("weight_decay,grad_norm", [(0.0, 2.0), (0.05, 2.0), (0.05, 1e3)],
                         ids=["adamax", "adamax_l2", "adamax_l2_unclipped"])
def test_adamax_matches_optax(weight_decay, grad_norm):
    """Adamax (optax.scale_by_adamax, L2 weight decay added to the gradient
    before the moments) over four updates; adam_mu_dtype is ignored, as optax's
    Adamax has no mu_dtype."""
    params, grads = _opt_case(2, 4)
    kw = dict(optim="adamax", adam_mu_dtype="bfloat16", grad_norm=grad_norm, weight_decay=weight_decay,
              learning_rate=1e-2, lr_mul=10.0)
    j_params = {n: jnp.asarray(p) for n, p in params.items()}
    t_params = {n: torch.from_numpy(p.copy()) for n, p in params.items()}
    tx = jopt.build_optimizer(JTrainConfig(**kw), j_params)
    j_state = jopt.set_schedule(tx.init(j_params), 1, 10)
    opt = topt.build_optimizer(TTrainConfig(**kw), t_params)
    t_state = topt.set_schedule(opt.init(t_params), 1, 10)
    assert all(m.dtype == torch.float32 for m in t_state.adam.mu.values())
    for g in grads:
        updates, j_state = tx.update({n: jnp.asarray(x) for n, x in g.items()}, j_state, j_params)
        j_params = optax.apply_updates(j_params, updates)
        t_state = opt.update(t_params, {n: torch.from_numpy(x) for n, x in g.items()}, t_state)
        np.testing.assert_allclose(float(topt.last_grad_norm(t_state)), float(jopt.last_grad_norm(j_state)), rtol=1e-6)
        for n in params:
            np.testing.assert_allclose(t_params[n].numpy(), np.asarray(j_params[n]), rtol=1e-6, atol=1e-7, err_msg=n)


@pytest.mark.parametrize("optim", ["adamw", "adam"])
def test_multisteps_matches_optax(optim):
    """Seven mini-steps at k = 3 (two boundaries and a partial window):
    parameters, the recorded grad norm (the last boundary's between
    boundaries), the schedule count and the mini-step counters against
    optax.MultiSteps over the JAX package's chain."""
    params, grads = _opt_case(3, 7)
    kw = dict(optim=optim, grad_norm=2.0, weight_decay=0.05, learning_rate=1e-2, lr_mul=10.0)
    j_params = {n: jnp.asarray(p) for n, p in params.items()}
    t_params = {n: torch.from_numpy(p.copy()) for n, p in params.items()}
    tx = optax.MultiSteps(jopt.build_optimizer(JTrainConfig(**kw), j_params), every_k_schedule=3)
    j_state = jopt.set_schedule(tx.init(j_params), 1, 10)
    opt = topt.MultiSteps(topt.build_optimizer(TTrainConfig(**kw), t_params), every_k=3)
    t_state = topt.set_schedule(opt.init(t_params), 1, 10)
    for g in grads:
        before = {n: p.clone() for n, p in t_params.items()}
        updates, j_state = tx.update({n: jnp.asarray(x) for n, x in g.items()}, j_state, j_params)
        j_params = optax.apply_updates(j_params, updates)
        t_state = opt.update(t_params, {n: torch.from_numpy(x) for n, x in g.items()}, t_state)
        assert (t_state.mini_step, t_state.gradient_step) == (int(j_state.mini_step), int(j_state.gradient_step))
        assert t_state.inner.schedule.count == t_state.gradient_step
        np.testing.assert_allclose(float(topt.last_grad_norm(t_state)), float(jopt.last_grad_norm(j_state)), rtol=1e-6)
        for n in params:
            np.testing.assert_allclose(t_params[n].numpy(), np.asarray(j_params[n]), rtol=1e-6, atol=1e-7, err_msg=n)
            if t_state.mini_step:  # inside a window nothing moves
                assert torch.equal(t_params[n], before[n])
            np.testing.assert_allclose(t_state.acc_grads[n].numpy(), np.asarray(j_state.acc_grads[n]), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("policy", ["", "full", "attn", "attn_qkv", "attn_mlp", "attn_qkv_mlp", "dots", "bogus"])
def test_remat_policy_rule(setup, policy):
    """'' and 'full' are plain per-layer remat; the JAX package's named
    policies resolve to a RematPolicy (tests/test_torch_remat.py holds their
    windows against the JAX package's); unknown names raise ValueError, as in
    the JAX package."""
    _, tc, _, _ = setup
    cfg = TTrainConfig(**_kw(remat=True, remat_policy=policy))
    if policy in ("", "full"):
        assert jstep.resolve_remat_policy(policy) is None and tstep.resolve_remat_policy(policy) is None
        tstep.make_train_step(tc, cfg, None, device="cpu")
        return
    if policy == "bogus":
        with pytest.raises(ValueError, match="remat_policy"):
            tstep.make_train_step(tc, cfg, None, device="cpu")
        return
    assert jstep.resolve_remat_policy(policy) is not None
    assert isinstance(tstep.resolve_remat_policy(policy), RematPolicy)
    tstep.make_train_step(tc, cfg, None, device="cpu")


@pytest.mark.parametrize("preset", ["160m", "410m", "1b"])
def test_flops_match_jax(preset):
    from mafed_tpu.core.config import model_config_for_preset as jpreset
    from mafed_tpu_torch.core.config import model_config_for_preset as tpreset

    jc, tc = jpreset(preset), tpreset(preset)
    for cached in (True, False):
        assert tflops.framework_window_flops(tc, 80, 3, 16, vision_cached=cached) == pytest.approx(
            jflops.framework_window_flops(jc, 80, 3, 16, vision_cached=cached), rel=1e-12)
    assert tflops.distill_step_flops_per_example(tc, 80) == pytest.approx(jflops.distill_step_flops_per_example(jc, 80), rel=1e-12)
    # a CE window of n_mb microbatches is n_mb * B CE examples; n_ce = 0 is one memory microbatch
    window = tflops.framework_window_flops(tc, 80, 3, 16)
    memory = tflops.framework_window_flops(tc, 80, 0, 16)
    assert window - memory == pytest.approx(3 * 16 * tflops.ce_example_flops(tc, 80), rel=1e-12)
    assert tflops.ce_example_flops(tc, 80, vision_cached=False) - tflops.ce_example_flops(tc, 80) == pytest.approx(
        jflops.vision_flops_per_image(jc), rel=1e-12)
    for cached in (True, False):  # bench_eval.py's decode: text 64, 10 new tokens
        assert tflops.framework_decode_flops_per_example(tc, 64, 10, vision_cached=cached) == pytest.approx(
            jflops.framework_decode_flops_per_example(jc, 64, 10, vision_cached=cached), rel=1e-12)


FACTORIES = {
    "make_train_step": lambda tc, cfg: tstep.make_train_step(tc, cfg, None),
    "make_ce_window_step": lambda tc, cfg: tstep.make_ce_window_step(tc, cfg, None, with_ewc=True),
    "make_distill_step": lambda tc, cfg: tstep.make_distill_step(tc, cfg, None),
    "make_mafed_window_step_unfused": lambda tc, cfg: tstep.make_mafed_window_step(tc, cfg, None, n_ce=3, fuse_ce_batch=False),
    "make_ewc_fisher_fn": lambda tc, cfg: tstep.make_ewc_fisher_fn(tc, cfg),
    "make_adaptive_weights_fn": lambda tc, cfg: tstep.make_adaptive_weights_fn(tc, cfg, [0, 1]),
}


@pytest.mark.parametrize("factory", list(FACTORIES))
def test_factories_refuse_a_missing_gpu(setup, factory):
    _, tc, _, _ = setup
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    with pytest.raises(RuntimeError, match="CUDA"):
        FACTORIES[factory](tc, TTrainConfig(**_kw()))


def test_steps_refuse_batches_on_another_device(setup):
    _, tc, params, mbs = setup
    kw = _kw()
    _, opt, state = _torch_state(params, tc, TTrainConfig(**kw))
    step = tstep.make_train_step(tc, TTrainConfig(**kw), opt, device="cpu")
    with pytest.raises(ValueError, match="must be on cpu"):
        step(state, to_torch(mbs[0], device="meta"))
