"""The named remat policies (training/step.py resolve_remat_policy,
models/gpt_neox.py RematPolicy) against plain per-layer remat and against
the JAX package's jax.checkpoint policies.

A policy only chooses which tensors of a layer stay alive between forward
and backward, so every policy's MAFED, CE and EWC windows must give the
numbers of full recompute: the port's bit for bit, the JAX package's window
under the same policy within abs 1e-5 (float32; tests/test_remat_policy.py's
tolerance), or 1e-6 relative where a scalar is large (the EWC window's
grad norm, ~430: float32 resolves ~3e-5 there). Under "attn" and the
policies that extend it the backward runs no flash forward; under "" and
"dots" it reruns one per layer.
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
from mafed_tpu_torch.kernels import attention as A
from mafed_tpu_torch.models import gpt_neox
from mafed_tpu_torch.models import vl_pythia as tvl
from mafed_tpu_torch.models.weights import params_from_jax
from mafed_tpu_torch.optim import optimizer as topt
from mafed_tpu_torch.training import step as tstep
from mafed_tpu_torch.training.train_state import TrainState, make_teacher, trainable_parameters
from tests.torch_helpers import batch, jax_params, stack, tiny_cfgs, to_torch, torch_model

N_CE, B, TEXT = 3, 2, 16
NAMED = ["attn", "attn_qkv", "attn_mlp", "attn_qkv_mlp", "dots"]
WINDOWS = ["mafed", "ce", "ewc"]
ATOL, SCALAR_RTOL = 1e-5, 1e-6


def _kw(policy):
    return dict(optim="adamw", weight_decay=0.01, learning_rate=5e-5, label_tail=8, compute_dtype="float32",
                reg_lambda=100.0, replay_coeff=1.0, distillation_coeff=1.0,
                distillation_modality_weighing_strategy="balanced",
                distillation_layer_weighing_strategy="discounted", distillation_layer_discount=0.5,
                remat_policy=policy)


@pytest.fixture(scope="module")
def setup():
    jcfg, tc = tiny_cfgs()
    params = jax_params(jcfg, seed=3)
    mbs = [batch(tc, B, TEXT, seed=10 + i, pad=2 + i) for i in range(N_CE + 1)]
    trainable, _ = split_params(params)
    rng = np.random.default_rng(7)
    fisher = jax.tree.map(lambda x: jnp.asarray(rng.uniform(0, 1, size=x.shape), jnp.float32), trainable)
    old = jax.tree.map(lambda x: (x + 0.01 * rng.normal(size=x.shape)).astype(jnp.float32), trainable)
    as_torch = lambda tree: params_from_jax(jax.tree.map(np.asarray, tree), tc)  # noqa: E731
    return {"jcfg": jcfg, "tc": tc, "params": params, "mbs": mbs, "j_ewc": (fisher, old),
            "t_ewc": (as_torch(fisher), as_torch(old)), "runs": {}}


def _jax_window(s, kind, policy):
    jcfg, params, mbs = s["jcfg"], s["params"], s["mbs"]
    cfg = JTrainConfig(**_kw(policy))
    trainable, frozen = split_params(params)
    tx = jopt.build_optimizer(cfg, trainable)
    state = JTrainState(jnp.zeros((), jnp.int32), trainable, frozen, jopt.set_schedule(tx.init(trainable), 0, 100))
    if kind == "mafed":
        teacher = jax.tree.map(lambda x: x.astype(jnp.bfloat16), trainable)
        step = jstep.make_mafed_window_step(jcfg, cfg, tx, n_ce=N_CE, donate=False)
        lang = jnp.full((jcfg.num_hidden_layers - 1,), 0.5, jnp.float32)
        state, m = step(state, teacher, {k: jnp.asarray(v) for k, v in stack(mbs[:N_CE]).items()},
                        {k: jnp.asarray(v) for k, v in mbs[N_CE].items()}, lang)
    else:
        step = jstep.make_ce_window_step(jcfg, cfg, tx, with_ewc=kind == "ewc", attn_impl="xla", donate=False)
        state, m = step(state, {k: jnp.asarray(v) for k, v in stack(mbs).items()},
                        s["j_ewc"] if kind == "ewc" else None)
    new = params_from_jax(jax.tree.map(np.asarray, state.trainable), s["tc"])
    return float(m["loss"]), float(m["grad_norm"]), {k: v.numpy() for k, v in new.items()}


def _torch_window(s, kind, policy):
    """(loss, grad norm, the updated trainable parameters, flash forwards run)."""
    tc, mbs = s["tc"], s["mbs"]
    cfg = TTrainConfig(**_kw(policy))
    model = torch_model(s["params"], tc)
    trainable = trainable_parameters(model)
    opt = topt.build_optimizer(cfg, trainable)
    state = TrainState(0, model, topt.set_schedule(opt.init(trainable), 0, 100))
    calls = _count_flash_forwards()
    try:
        if kind == "mafed":
            step = tstep.make_mafed_window_step(tc, cfg, opt, n_ce=N_CE, device="cpu")
            lang = torch.full((tc.num_hidden_layers - 1,), 0.5)
            state, m = step(state, make_teacher(model), to_torch(stack(mbs[:N_CE])), to_torch(mbs[N_CE]), lang)
        else:
            step = tstep.make_ce_window_step(tc, cfg, opt, with_ewc=kind == "ewc", device="cpu")
            state, m = step(state, to_torch(stack(mbs)), s["t_ewc"] if kind == "ewc" else None)
    finally:
        A.flash_forward_plain = calls.pop("plain")
    new = {k: p.detach().clone() for k, p in trainable_parameters(model).items()}
    return float(m["loss"]), float(m["grad_norm"]), new, calls["n"]


def _count_flash_forwards():
    """Counts calls of the flash forward's plain version (what it runs on the CPU) until restored."""
    calls = {"n": 0, "plain": A.flash_forward_plain}

    def counting(*args):
        calls["n"] += 1
        return calls["plain"](*args)

    A.flash_forward_plain = counting
    return calls


def _port(s, kind, policy):
    key = ("port", kind, policy)
    if key not in s["runs"]:
        s["runs"][key] = _torch_window(s, kind, policy)
    return s["runs"][key]


@pytest.mark.parametrize("kind", WINDOWS)
@pytest.mark.parametrize("policy", NAMED)
def test_policy_window_matches_full_remat_and_jax(setup, policy, kind):
    loss, gnorm, new, forwards = _port(setup, kind, policy)
    base_loss, base_gnorm, base_new, base_forwards = _port(setup, kind, "")
    # flash forwards: each differentiated layer, the teacher's (L - 2, early
    # exit), and a rerun per differentiated layer in backward unless kept
    layers = setup["tc"].num_hidden_layers
    differentiated = 2 * layers if kind == "mafed" else layers
    teacher = layers - 2 if kind == "mafed" else 0
    assert base_forwards == 2 * differentiated + teacher
    assert forwards == differentiated + teacher + (0 if policy.startswith("attn") else differentiated)
    # the port: the same numbers as full recompute, bit for bit
    assert (loss, gnorm) == (base_loss, base_gnorm)
    assert all(torch.equal(new[k], base_new[k]) for k in base_new)
    # the JAX package's window under the same policy
    j_loss, j_gnorm, j_new = _jax_window(setup, kind, policy)
    assert loss == pytest.approx(j_loss, abs=ATOL, rel=SCALAR_RTOL)
    assert gnorm == pytest.approx(j_gnorm, abs=ATOL, rel=SCALAR_RTOL)
    for k, want in j_new.items():
        np.testing.assert_allclose(new[k].numpy(), want, rtol=0, atol=ATOL, err_msg=k)


@pytest.mark.parametrize("kind", WINDOWS)
def test_full_remat_window_matches_jax(setup, kind):
    loss, gnorm, new, _ = _port(setup, kind, "")
    j_loss, j_gnorm, j_new = _jax_window(setup, kind, "")
    assert loss == pytest.approx(j_loss, abs=ATOL, rel=SCALAR_RTOL)
    assert gnorm == pytest.approx(j_gnorm, abs=ATOL, rel=SCALAR_RTOL)
    for k, want in j_new.items():
        np.testing.assert_allclose(new[k].numpy(), want, rtol=0, atol=ATOL, err_msg=k)


@pytest.mark.parametrize("policy", ["", "full"] + NAMED)
def test_backward_reruns_flash_forward_only_without_attn(setup, policy):
    """One remat'd CE pass, forward and backward counted apart: the backward
    reruns a flash forward per layer unless the policy keeps the attention."""
    tc = setup["tc"]
    model = torch_model(setup["params"], tc)
    b = to_torch(setup["mbs"][0])
    calls = _count_flash_forwards()
    try:
        loss = tvl.forward(model, b["input_ids"], b["attention_mask"], b["labels"], patch_embeddings=b["patches"],
                           dtype=torch.float32, loss_only=True, remat_layers=True,
                           remat_policy=tstep.resolve_remat_policy(policy)).loss
        forward = calls["n"]
        loss.backward()
        backward = calls["n"] - forward
    finally:
        A.flash_forward_plain = calls.pop("plain")
    layers = tc.num_hidden_layers
    assert forward == layers
    assert backward == (0 if policy.startswith("attn") else layers)


# what each policy keeps per layer, in call order: the tagged products of
# gpt_neox.dense and the flash forward's (o, lse)
KEPT = {
    "attn": ["flash", "attn_out"],
    "attn_qkv": ["qkv", "flash", "attn_out"],
    "attn_mlp": ["flash", "attn_out", "mlp_up"],
    "attn_qkv_mlp": ["qkv", "flash", "attn_out", "mlp_up"],
    "dots": ["qkv", "attn_out", "mlp_up", "mlp_down"],
}


@pytest.mark.parametrize("policy", NAMED)
def test_policy_keeps_the_named_tensors(setup, policy, monkeypatch):
    """What each layer's forward keeps for the backward, by name and shape;
    the recompute takes all of it back."""
    tc = setup["tc"]
    model = torch_model(setup["params"], tc)
    b = to_torch(setup["mbs"][0])
    stashes = []

    class Recorded(gpt_neox._Stash):
        def __init__(self, keep):
            super().__init__(keep)
            stashes.append(self)

    monkeypatch.setattr(gpt_neox, "_Stash", Recorded)
    loss = tvl.forward(model, b["input_ids"], b["attention_mask"], b["labels"], patch_embeddings=b["patches"],
                       dtype=torch.float32, loss_only=True, remat_layers=True,
                       remat_policy=tstep.resolve_remat_policy(policy)).loss
    assert len(stashes) == tc.num_hidden_layers
    h, inter = tc.hidden_size, tc.intermediate_size
    tokens = b["input_ids"].shape[0] * (tc.vision.num_patches + b["input_ids"].shape[1])
    widths = {"qkv": 3 * h, "attn_out": h, "mlp_up": inter, "mlp_down": h}
    for stash in stashes:
        assert [name for name, _ in stash.kept] == KEPT[policy]
        for name, value in stash.kept:
            if name == "flash":
                o, lse = value
                assert o.shape == (B, tc.num_attention_heads, tokens // B, tc.head_dim)
            else:
                assert value.reshape(-1, value.shape[-1]).shape == (tokens, widths[name])
    loss.backward()
    assert all(stash.kept == [] for stash in stashes)


def test_resolve_remat_policy_names():
    assert tstep.resolve_remat_policy("") is None and tstep.resolve_remat_policy("full") is None
    for name in NAMED:
        assert isinstance(tstep.resolve_remat_policy(name), gpt_neox.RematPolicy)
        assert jstep.resolve_remat_policy(name) is not None
    assert tstep.resolve_remat_policy("attn_qkv").keep == {"attn_out", "qkv", "flash"}
    assert tstep.resolve_remat_policy("dots").keep == {"qkv", "attn_out", "mlp_up", "mlp_down"}
    for bad in ("bogus", "mlp_up"):
        with pytest.raises(ValueError, match="unknown remat_policy"):
            tstep.resolve_remat_policy(bad)
        with pytest.raises(ValueError):
            jstep.resolve_remat_policy(bad)
