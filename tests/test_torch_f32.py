"""The port at float32 inputs (`--compute_dtype float32`) on the CPU.

* The kernel wrappers' dispatch, with the library mocked (no card): at every
  head_dim the JAX dispatcher sends to its Pallas kernels and at bfloat16 and
  float32, which C entry point a forward and backward launch and how many
  output slices its grid takes (`build.route`); a float32 call never reaches
  `masked_attention` or a plain version; float16 and mixed dtypes raise.
* The CL trainer through its command-line parser at --compute_dtype float32:
  its windows' attention is float32 (the float32 kernels' on a card), eval's
  and the tower's bfloat16, as in the JAX package.
* A known divergence: on the JAX side, a tiny float32 MAFED window with its
  Pallas kernels (interpret mode) under `_PALLAS_BWD_MODE` "always" (the
  Pallas backward, exact float32 products at float32 inputs) and "auto" (at
  1024 keys or fewer the custom VJP's dense backward, which casts q, k, v and
  dO to bfloat16 whatever their dtype). The port follows "always": its
  window's metrics and parameters, and its CE gradients, are held against
  that run at the float32 tolerances of tests/test_torch_window.py; the gap
  to "auto" is measured and must stay above them.
"""

import contextlib
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mafed_tpu.kernels import attention as jattn
from mafed_tpu.training import step as jstep
from mafed_tpu.training.train_state import split_params
from mafed_tpu_torch.kernels import attention as tattn
from mafed_tpu_torch.kernels import build
from mafed_tpu_torch.models.weights import params_from_jax
from mafed_tpu_torch.training import step as tstep
from mafed_tpu_torch.training.train_state import trainable_parameters
from tests import test_torch_window as window_test
from tests.torch_helpers import jax_params, one_torch_thread, tiny_cfgs, torch_model  # noqa: F401

HEAD_DIMS = [64, 96, 128, 256, 384, 512, 640]
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# the argument of each entry point that carries head_dim
HEAD_DIM_ARG = {"flash_fwd": 10, "flash_bwd_dkv": 13, "flash_bwd_dq": 12}


@pytest.fixture
def mocked_card(monkeypatch):
    """CPU tensors that call themselves CUDA tensors, and a kernel library
    that records each entry point's call and returns success: the wrappers
    run as on a card, up to the launch. The plain versions and
    masked_attention fail the test if anything calls them. Yields the calls,
    (entry point, arguments)."""
    calls = []

    class Library:
        def __getattr__(self, entry):
            def launch(*args):
                calls.append((entry, args))
                return 0
            return launch

    monkeypatch.setattr(tattn, "load_library", Library)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: types.SimpleNamespace(cuda_stream=0))
    for name in ("flash_forward_plain", "flash_backward_plain", "masked_attention"):
        monkeypatch.setattr(tattn, name, lambda *a, _name=name, **k: pytest.fail(f"{_name} on a CUDA call"))
    tattn.reset_launches()
    yield calls
    tattn.reset_launches()


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("head_dim", HEAD_DIMS)
def test_wrappers_route_each_dtype_and_head_dim(mocked_card, head_dim, dtype):
    """A causal, key-padded attention and its backward through
    dot_product_attention: one launch of each kernel, through the entry point
    of the call's dtype with the call's head_dim, counted under that dtype
    and head_dim; the slices of the grid as the C launchers take them."""
    rng = np.random.default_rng(0)
    q, k, v, g = (torch.from_numpy(rng.normal(size=(2, 2, 40, head_dim)).astype(np.float32)).to(DTYPES[dtype])
                  for _ in range(4))
    mask = torch.ones(2, 40, dtype=torch.int32)
    mask[:, :3] = 0
    leaves = [x.requires_grad_(True) for x in (q, k, v)]
    tattn.dot_product_attention(*leaves, key_padding_mask=mask, causal=True).backward(g)
    kernels = ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")
    routes = [build.route(name, dtype, head_dim) for name in kernels]
    assert [entry for entry, _ in mocked_card] == [r.entry for r in routes]
    assert [args[HEAD_DIM_ARG[name]] for name, (_, args) in zip(kernels, mocked_card)] == [head_dim] * 3
    assert [entry.endswith("_f32") for entry, _ in mocked_card] == [dtype == "float32"] * 3
    if dtype == "float32":
        assert {r.instantiation for r in routes} <= set(build.F32_INSTANTIATIONS)
        fwd_width = head_dim if head_dim <= 128 else 512
        assert [r.slices for r in routes] == [-(-head_dim // fwd_width)] + [-(-head_dim // 128)] * 2
    else:
        wide = build.wide_head_dim(head_dim)  # the wide forward in pieces of up to 512 columns
        assert [r.slices for r in routes] == ([-(-head_dim // 512)] + [head_dim // 128] * 2 if wide else [1] * 3)
    assert tattn.LAUNCHES_BY_DTYPE == {dtype: dict.fromkeys(kernels, 1)}
    assert tattn.LAUNCHES_BY_HEAD_DIM == {head_dim: dict.fromkeys(kernels, 1)}


def test_wrappers_refuse_float16_and_mixed_dtypes(mocked_card):
    """float16 (no kernel takes it), a float32 k beside a bfloat16 q, a
    bfloat16 dO or o beside float32 q: TypeError, and nothing launches."""
    x = torch.zeros(1, 2, 64, 64)
    lse = torch.zeros(1, 2, 64)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        tattn.flash_forward(x.half(), x.half(), x.half(), None, True, 0.125)
    with pytest.raises(TypeError, match="k must be torch.bfloat16"):
        tattn.flash_forward(x.bfloat16(), x, x.bfloat16(), None, True, 0.125)
    with pytest.raises(TypeError, match="do must be torch.float32"):
        tattn.flash_bwd_dq(x, x, x, None, x.bfloat16(), lse, lse, True, 0.125)
    with pytest.raises(TypeError, match="o must be torch.float32"):
        tattn.flash_backward(x, x, x, None, x.bfloat16(), lse, x, True, 0.125)
    assert mocked_card == [] and tattn.LAUNCHES_BY_DTYPE == {}


def test_trainer_cli_trains_at_float32(tmp_path, monkeypatch):
    """The shipped config through the CLI's parser with --compute_dtype
    float32 and a tiny model, one CE task and one MAFED task on the CPU:
    every attention of the windows (their CE and student passes, backward
    and recompute, the in-step teacher) is float32, which the float32
    kernels take on a card; eval's and the tower's are bfloat16 (the JAX
    package evaluates in bfloat16 too); the run ends with an accuracy
    matrix."""
    import chip_smoke  # the synthetic data writer and the sequence's command line (it imports the port only)
    from mafed_tpu_torch.core.config import build_arg_parser, parse_with_config
    from mafed_tpu_torch.trainer.continual import ContinualLearningTrainer

    seen = {}
    forward, backward = tattn.flash_forward, tattn.flash_backward

    def count(kind, q):
        seen.setdefault(str(q.dtype).split(".")[1], {"flash_fwd": 0, "flash_bwd": 0})[kind] += 1

    monkeypatch.setattr(tattn, "flash_forward", lambda q, *a: count("flash_fwd", q) or forward(q, *a))
    monkeypatch.setattr(tattn, "flash_backward", lambda q, *a: count("flash_bwd", q) or backward(q, *a))
    root = str(tmp_path)
    chip_smoke.write_synthetic_vqa(root, ("taskA", "taskB"), 32, 8)
    argv = chip_smoke.cl_sequence_argv(root) + chip_smoke.STREAMING_SWITCHES + [
        "--compute_dtype", "float32", "--batch_size", "4", "--cl_memory", "8", "--val_batch_size", "4"]
    cfg = parse_with_config(build_arg_parser(), argv)
    assert cfg.compute_dtype == "float32"
    model_cfg = chip_smoke.tiny_config(64)
    trainer = ContinualLearningTrainer(cfg, model_cfg=model_cfg, synthetic_images=True, device="cpu")
    result = trainer.main()
    assert np.isfinite(result["accuracy_matrix"]).all()
    assert [log["steps"] for log in trainer.fit_logs] == [{"ce_window": 2}, {"mafed_window": 2}]
    windows = chip_smoke.sequence_launches(cfg, model_cfg, 2, 2, 0, 0, 0, in_step_teacher=True)[64]
    assert seen["float32"] == {"flash_fwd": windows["flash_fwd"], "flash_bwd": windows["flash_bwd_dq"]}
    assert seen["bfloat16"]["flash_bwd"] == 0 and seen["bfloat16"]["flash_fwd"] > 0 and len(seen) == 2
    for name in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"):
        assert build.route(name, "float32", model_cfg.head_dim).entry == build.ENTRY_POINTS[name] + "_f32"


# ---------------------------------------------------------------------------
# The JAX custom VJP's "auto" backward against "always" at float32
# ---------------------------------------------------------------------------

def _jax_window(jcfg, params, kw, ce_stack, distill, mode):
    """One JAX window with attn_impl="pallas" (interpret mode) under
    `_PALLAS_BWD_MODE` = mode: (trainable after the update, metrics), and
    the CE loss's gradients over the window's merged CE rows."""
    from mafed_tpu.core.config import TrainConfig as JTrainConfig
    from mafed_tpu.optim import optimizer as jopt
    from mafed_tpu.training.train_state import TrainState as JTrainState

    jattn._INTERPRET, jattn._PALLAS_BWD_MODE = True, mode
    try:
        train_cfg = JTrainConfig(**kw)
        trainable, frozen = split_params(params)
        teacher = jax.tree.map(lambda x: x.astype(jnp.bfloat16), trainable)
        tx = jopt.build_optimizer(train_cfg, trainable)
        state = JTrainState(jnp.zeros((), jnp.int32), trainable, frozen, jopt.set_schedule(tx.init(trainable), 0, 100))
        step = jstep.make_mafed_window_step(jcfg, train_cfg, tx, n_ce=window_test.N_CE, donate=False,
                                            attn_impl="pallas")
        lang = jnp.full((jcfg.num_hidden_layers - 1,), 0.5, jnp.float32)
        state, metrics = step(state, teacher, {k: jnp.asarray(v) for k, v in ce_stack.items()},
                              {k: jnp.asarray(v) for k, v in distill.items()}, lang)
        merged = {k: jnp.asarray(v.reshape(-1, *v.shape[2:])) for k, v in ce_stack.items()}
        grads = jax.grad(jstep._ce_loss)(trainable, frozen, jcfg, merged, jnp.float32, "pallas", label_tail=kw["label_tail"])
        return state.trainable, {k: np.asarray(v) for k, v in metrics.items()}, jax.tree.map(np.asarray, grads)
    finally:
        jattn._INTERPRET, jattn._PALLAS_BWD_MODE = False, "auto"


@pytest.fixture(scope="module")
def f32_windows():
    """The tiny model's float32 window on the JAX side under "always" and
    "auto", and the port's (the plain versions on the CPU), from the same
    parameters and batches; the CE gradients of each."""
    jcfg, tc = tiny_cfgs()
    params = jax_params(jcfg, seed=3)
    ce_stack, distill = window_test._batches(tc)
    kw = window_test._train_kwargs("float32", None)
    jax_runs = {mode: _jax_window(jcfg, params, kw, ce_stack, distill, mode) for mode in ("always", "auto")}
    model, history = window_test._run_torch(tc, params, kw, ce_stack, distill, windows=1)
    port_model = torch_model(params, tc)
    merged = {k: torch.from_numpy(v.reshape(-1, *v.shape[2:])) for k, v in ce_stack.items()}
    loss = tstep._ce_loss(port_model, merged, merged["patches"].float(), torch.float32, kw["label_tail"], remat=False)
    loss.backward()
    port_grads = {n: p.grad.numpy() for n, p in trainable_parameters(port_model).items()}
    return tc, jax_runs, (model, history[0], port_grads)


def _by_name(tree, tc):
    return {n: t.numpy() for n, t in params_from_jax(jax.tree.map(np.asarray, tree), tc).items()}


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_port_f32_window_follows_the_pallas_backward(f32_windows):
    """The port's float32 window against the JAX window whose flash backward
    is the Pallas kernels ("always"): metrics within rtol 1e-5, parameters
    after the update within atol 1e-6 / rtol 1e-5, each CE gradient within
    1e-5 of its norm (float32 summation order only)."""
    tc, jax_runs, (model, port_metrics, port_grads) = f32_windows
    trainable, metrics, grads = jax_runs["always"]
    for key in ("loss", "ce_loss", "distill_loss", "grad_norm", "distill_layer_losses"):
        np.testing.assert_allclose(port_metrics[key], metrics[key], rtol=1e-5, atol=1e-7, err_msg=key)
    want = _by_name(trainable, tc)
    for name, p in trainable_parameters(model).items():
        np.testing.assert_allclose(p.detach().numpy(), want[name], atol=1e-6, rtol=1e-5, err_msg=name)
    want = _by_name(grads, tc)
    errs = {name: _rel(g, want[name]) for name, g in port_grads.items()}
    assert max(errs.values()) <= 1e-5, errs


def test_jax_auto_backward_rounds_f32_to_bf16(f32_windows):
    """The size of the divergence: under "auto" (the dense backward on
    bfloat16 operands at these 20 keys) the JAX package's CE gradients of the
    attention weights move from the exact float32 ones by far more than the
    port's float32 tolerance, while the forward (the losses) is the same
    Pallas kernel in both. Measured (this tiny model, 3 layers, 2 heads of
    64, 20 keys): the query_key_value gradients 1.85e-3 to 2.02e-3 of their
    norm apart, the window's grad norm 6.4e-5 apart."""
    tc, jax_runs, _ = f32_windows
    (_, always, g_always), (_, auto, g_auto) = jax_runs["always"], jax_runs["auto"]
    for key in ("loss", "ce_loss", "distill_loss"):
        np.testing.assert_allclose(auto[key], always[key], rtol=1e-6, err_msg=key)
    exact, rounded = _by_name(g_always, tc), _by_name(g_auto, tc)
    gaps = {name: _rel(rounded[name], exact[name]) for name in exact if "attention.query_key_value.weight" in name}
    assert len(gaps) == tc.num_hidden_layers
    assert 1e-4 < max(gaps.values()) < 5e-2, gaps
    assert abs(auto["grad_norm"] - always["grad_norm"]) / always["grad_norm"] > 1e-6
