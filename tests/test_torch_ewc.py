"""EWC in the port against the JAX package: `ewc_penalty` and its gradient,
the EWC window's loss gradient, the EWC CE window and train step, and the
Fisher accumulator `make_ewc_fisher_fn`.

Same tiny model and parameters on both sides (tests/torch_helpers.py), the
EWC state (F, theta*) made from a numpy seed: F uniform in [0, 1), theta*
the initial parameters plus N(0, 0.01^2) noise, stored in float32 or
bfloat16 (`ewc_state_dtype`). JAX steps with `attn_impl="xla"`.

Tolerances, float32: penalty and losses at rtol 1e-5; gradients and Fisher
importances per tensor at rtol 1e-5 with an atol of 1e-6 of the tensor's
largest magnitude (the attention's key biases have a zero gradient up to
rounding, since softmax does not see a shift that is the same for every
key, so their relative error means nothing); parameters after two updates
at atol 1e-6 / rtol 1e-5, as tests/test_torch_window.py. bfloat16 compute:
losses at rtol 3e-2.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mafed_tpu.core.config import TrainConfig as JTrainConfig
from mafed_tpu.optim import optimizer as jopt
from mafed_tpu.training import step as jstep
from mafed_tpu.training.train_state import TrainState as JTrainState, split_params
from mafed_tpu_torch.core.config import TrainConfig as TTrainConfig
from mafed_tpu_torch.models.weights import params_from_jax
from mafed_tpu_torch.optim import optimizer as topt
from mafed_tpu_torch.training import step as tstep
from mafed_tpu_torch.training.train_state import TrainState, trainable_parameters
from tests.torch_helpers import batch, jax_params, stack, tiny_cfgs, to_torch, torch_model

N_MB, B, TEXT = 4, 2, 16
LR = 5e-5
REG_LAMBDA = 2.0


def _kw(compute_dtype="float32", **over):
    kw = dict(optim="adamw", weight_decay=0.01, learning_rate=LR, label_tail=8, compute_dtype=compute_dtype,
              reg_lambda=REG_LAMBDA)
    kw.update(over)
    return kw


@pytest.fixture(scope="module")
def setup():
    jcfg, tc = tiny_cfgs()
    params = jax_params(jcfg, seed=5)
    mbs = [batch(tc, B, TEXT, seed=40 + i, pad=1 + i) for i in range(N_MB)]
    return jcfg, tc, params, mbs


def _ewc_state(params, tc, dtype=jnp.float32, seed=7):
    """(JAX (F, theta*) pytrees, the port's name-keyed (F, theta*))."""
    trainable, _ = split_params(params)
    rng = np.random.default_rng(seed)
    fisher = jax.tree.map(lambda x: jnp.asarray(rng.uniform(0, 1, size=x.shape), dtype), trainable)
    old = jax.tree.map(lambda x: (x + 0.01 * rng.normal(size=x.shape)).astype(dtype), trainable)
    as_torch = lambda tree: params_from_jax(jax.tree.map(np.asarray, tree), tc)  # noqa: E731
    return (fisher, old), (as_torch(fisher), as_torch(old))


def _close_per_tensor(got: torch.Tensor, want: np.ndarray, name: str):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-6 * np.abs(want).max(), err_msg=name)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_ewc_penalty_and_gradient_match_jax(setup, state_dtype):
    jcfg, tc, params, _ = setup
    (j_ewc, t_ewc) = _ewc_state(params, tc, jnp.dtype(state_dtype))
    if state_dtype == "bfloat16":
        assert all(v.dtype == torch.bfloat16 for v in t_ewc[0].values())
    trainable, _ = split_params(params)
    j_val, j_grad = jax.value_and_grad(lambda tr: jstep.ewc_penalty(tr, j_ewc, REG_LAMBDA))(trainable)
    model = torch_model(params, tc)
    t_params = trainable_parameters(model)
    t_val = tstep.ewc_penalty(t_params, t_ewc, REG_LAMBDA)
    grads = torch.autograd.grad(t_val, list(t_params.values()))
    np.testing.assert_allclose(float(t_val.detach()), float(j_val), rtol=1e-5)
    j_sd = params_from_jax(jax.tree.map(np.asarray, j_grad), tc)
    for (name, _), g in zip(t_params.items(), grads):
        _close_per_tensor(g, j_sd[name].numpy(), name)


def test_ewc_window_loss_gradient_matches_jax(setup):
    """d(CE over the merged window + penalty)/d theta, per parameter, against
    jax.grad of the same composition (the JAX window's loss_fn)."""
    jcfg, tc, params, mbs = setup
    j_ewc, t_ewc = _ewc_state(params, tc)
    w = stack(mbs)
    trainable, frozen = split_params(params)
    merged_j = {k: jstep._merge_window(jnp.asarray(v)) for k, v in w.items()}

    def j_loss(tr):
        ce = jstep._ce_loss(tr, frozen, jcfg, merged_j, jnp.float32, "xla", remat=True, label_tail=8)
        return ce + jstep.ewc_penalty(tr, j_ewc, REG_LAMBDA)

    j_val, j_grad = jax.jit(jax.value_and_grad(j_loss))(trainable)
    model = torch_model(params, tc)
    t_params = trainable_parameters(model)
    merged = {k: tstep._merge_window(v) for k, v in to_torch(w).items()}
    t_val = tstep._ce_loss(model, merged, merged["patches"], torch.float32, 8, remat=True)
    t_val = t_val + tstep.ewc_penalty(t_params, t_ewc, REG_LAMBDA)
    grads = torch.autograd.grad(t_val, list(t_params.values()))
    np.testing.assert_allclose(float(t_val.detach()), float(j_val), rtol=1e-5)
    j_sd = params_from_jax(jax.tree.map(np.asarray, j_grad), tc)
    for (name, _), g in zip(t_params.items(), grads):
        _close_per_tensor(g, j_sd[name].numpy(), name)


def _states(params, tc, kw):
    trainable, frozen = split_params(params)
    tx = jopt.build_optimizer(JTrainConfig(**kw), trainable)
    jstate = JTrainState(jnp.zeros((), jnp.int32), trainable, frozen, jopt.set_schedule(tx.init(trainable), 0, 100))
    model = torch_model(params, tc)
    t_trainable = trainable_parameters(model)
    opt = topt.build_optimizer(TTrainConfig(**kw), t_trainable)
    return tx, jstate, model, opt, TrainState(0, model, topt.set_schedule(opt.init(t_trainable), 0, 100))


@pytest.mark.parametrize("step_kind", ["ce_window", "train_step"])
def test_ewc_steps_match_jax_f32(setup, step_kind):
    """Two EWC CE windows (or two EWC microbatch steps), penalty included:
    losses, grad norms and the parameters after both updates."""
    jcfg, tc, params, mbs = setup
    kw = _kw()
    j_ewc, t_ewc = _ewc_state(params, tc)
    tx, jstate, model, opt, state = _states(params, tc, kw)
    if step_kind == "ce_window":
        jfn = jstep.make_ce_window_step(jcfg, JTrainConfig(**kw), tx, with_ewc=True, attn_impl="xla", donate=False)
        tfn = tstep.make_ce_window_step(tc, TTrainConfig(**kw), opt, with_ewc=True, device="cpu")
        inputs = [stack(mbs), stack(mbs[::-1])]
    else:
        jfn = jstep.make_train_step(jcfg, JTrainConfig(**kw), tx, with_ewc=True, attn_impl="xla", donate=False)
        tfn = tstep.make_train_step(tc, TTrainConfig(**kw), opt, with_ewc=True, device="cpu")
        inputs = mbs[:2]
    for x in inputs:
        jstate, jm = jfn(jstate, {k: jnp.asarray(v) for k, v in x.items()}, j_ewc)
        state, tm = tfn(state, to_torch(x), t_ewc)
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(tm[key].numpy(), np.asarray(jm[key]), rtol=1e-5, err_msg=key)
    j_sd = params_from_jax(jax.tree.map(np.asarray, jstate.trainable), tc)
    for name, p in trainable_parameters(model).items():
        np.testing.assert_allclose(p.detach().numpy(), j_sd[name].numpy(), atol=1e-6, rtol=1e-5, err_msg=name)


def test_ewc_window_matches_jax_bf16(setup):
    """bf16 compute, the EWC state stored in bf16."""
    jcfg, tc, params, mbs = setup
    kw = _kw("bfloat16", ewc_state_dtype="bfloat16")
    j_ewc, t_ewc = _ewc_state(params, tc, jnp.bfloat16)
    tx, jstate, _, opt, state = _states(params, tc, kw)
    _, jm = jstep.make_ce_window_step(jcfg, JTrainConfig(**kw), tx, with_ewc=True, attn_impl="xla", donate=False)(
        jstate, {k: jnp.asarray(v) for k, v in stack(mbs).items()}, j_ewc)
    _, tm = tstep.make_ce_window_step(tc, TTrainConfig(**kw), opt, with_ewc=True, device="cpu")(
        state, to_torch(stack(mbs)), t_ewc)
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=3e-2, err_msg=key)


def test_fisher_matches_jax(setup):
    """importances += (d(bsz * loss)/d theta)^2 over two batches (of sizes 2
    and 3), float32, against make_ewc_fisher_fn."""
    jcfg, tc, params, mbs = setup
    kw = _kw()
    batches = [mbs[0], batch(tc, 3, TEXT, seed=50, pad=2)]
    trainable, frozen = split_params(params)
    jfisher = jstep.make_ewc_fisher_fn(jcfg, JTrainConfig(**kw), attn_impl="xla")
    j_imp = jax.tree.map(lambda x: jnp.zeros(x.shape, jnp.float32), trainable)
    model = torch_model(params, tc)
    t_params = trainable_parameters(model)
    tfisher = tstep.make_ewc_fisher_fn(tc, TTrainConfig(**kw), device="cpu")
    t_imp = {k: torch.zeros_like(p) for k, p in t_params.items()}
    before = {k: p.detach().clone() for k, p in t_params.items()}
    for bt in batches:
        j_imp = jfisher(trainable, frozen, {k: jnp.asarray(v) for k, v in bt.items()}, j_imp)
        out = tfisher(model, to_torch(bt), t_imp)
        assert out is t_imp
    j_sd = params_from_jax(jax.tree.map(np.asarray, j_imp), tc)
    assert set(j_sd) == set(t_imp)
    for name, v in t_imp.items():
        assert v.dtype == torch.float32
        _close_per_tensor(v, j_sd[name].numpy(), name)
    # no gradient is left on the model and nothing moved
    assert all(p.grad is None for p in model.parameters())
    assert all(torch.equal(p, before[k]) for k, p in t_params.items())
