"""The port's tensor parallelism (mafed_tpu_torch/core/mesh.py,
models/tensor_parallel.py) against the JAX package's (data, model) layout:
the partition rule, the layers, the gather, eval, the CE / EWC windows and
the fused MAFED windows of tests/mp_worker.py's `_tp_step_probe` on a
(2, 2) grid. Ranks are processes of tests/torch_tp_worker.py over gloo on
the CPU, each group on a port of its own, each wait bounded.

Tolerances (float32 compute):
  * column -> row MLP, vocab-parallel embedding and CE, a decoder layer
    with the parallel residual (one reduction) and without (two), on 2
    ranks against the dense layers: outputs and gradients atol 1e-6;
  * the gather of a sharded model: bit-equal to the full weights; greedy
    tokens and validate_vqa of the gathered copy equal to one process's;
  * CE windows under [1, 2] against one process: metrics rtol 1e-5,
    parameters atol 1e-5 (lr / 100: AdamW moves an element whose gradient
    is rounding noise by up to lr); the remat policies "" and "dots" under
    [1, 2] bit-equal; the Fisher rtol 1e-4 (atol 1e-6 of its largest
    entry); the EWC window's metrics rtol 1e-5;
  * two MAFED windows on 4 ranks [2, 2] against the JAX package's (2, 2)
    mesh (attn_impl "xla"): losses rtol 2e-5 / atol 1e-6, the gathered
    parameters atol 1e-5, the optimizer state's round trip through a file
    exactly 0.0.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from mafed_tpu.core.config import ModelConfig as JModelConfig, TrainConfig as JTrainConfig, VisionConfig as JVision
from mafed_tpu.core.mesh import batch_sharding, make_mesh as jmake_mesh, param_partition_spec as jspec, shard_params
from mafed_tpu.models import vl_pythia as jvl
from mafed_tpu.models.weights import params_to_reference_state_dict
from mafed_tpu.optim.optimizer import build_optimizer as jbuild, set_schedule as jset_schedule
from mafed_tpu.optim.sched import linear_warmup_schedule as jschedule
from mafed_tpu.training.step import make_mafed_window_step as jwindow
from mafed_tpu.training.train_state import TrainState as JTrainState, split_params
from mafed_tpu_torch.core.device import check_layout
from mafed_tpu_torch.core.mesh import param_partition_spec, resolve_mesh_shape
from mafed_tpu_torch.models.weights import load_safetensors, params_from_jax
from mafed_tpu_torch.utils.checkpoint import save_task_checkpoint
from tests import torch_mp_worker as MPW
from tests import torch_tp_worker as W
from tests.torch_helpers import jax_params, one_torch_thread, tiny_cfgs  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAIT_S = 300
LAYER_ATOL, METRIC_RTOL, PARAM_ATOL, FISHER_RTOL = 1e-6, 1e-5, 1e-5, 1e-4
JAX_LOSS_RTOL, JAX_LOSS_ATOL, JAX_PARAM_ATOL = 2e-5, 1e-6, 1e-5


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_groups(root: str, groups) -> dict:
    """Start every (world, tag, mode, mesh) group of tests/torch_tp_worker.py
    at once, a free port each; wait for each rank within WAIT_S; {tag: [each
    rank's result]}."""
    env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = []
    for world, tag, mode, mesh in groups:
        port = str(_free_port())
        procs += [(tag, subprocess.Popen([sys.executable, W.__file__, str(r), str(world), port, root, tag, mode,
                                          *map(str, mesh)], cwd=REPO, env=env, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True)) for r in range(world)]
    outs = []
    try:
        for _, p in procs:
            outs.append(p.communicate(timeout=WAIT_S)[0])
    finally:
        for _, p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for (tag, p), out in zip(procs, outs):
        assert p.returncode == 0, f"{tag} rank failed:\n{out[-6000:]}"
    results = {}
    for world, tag, _, _ in groups:
        results[tag] = []
        for r in range(world):
            with open(os.path.join(root, f"worker_{tag}_{r}.json")) as f:
                results[tag].append(json.load(f))
    return results


# --- the partition rule and the grid -----------------------------------------------------------------------

def _marked_jax_params(jcfg):
    """init_params's tree with each leaf replaced by k * 1e4 + the index
    along the axis JAX's rule shards (0 where it replicates): after
    params_to_reference_state_dict a torch entry's values vary along the
    dim that axis became, and only there."""
    params = jax.tree.map(np.asarray, jvl.init_params(jcfg, jax.random.PRNGKey(0)))
    leaves, treedef = jax.tree_util.tree_flatten_with_path(params)
    marked = []
    for k, (path, leaf) in enumerate(leaves):
        names = tuple(str(getattr(p, "key", p)) for p in path)
        spec = tuple(jspec(names, leaf))
        axis = spec.index("model") if "model" in spec else None
        value = np.full(leaf.shape, k * 1e4, np.float64)
        if axis is not None:
            shape = [1] * leaf.ndim
            shape[axis] = leaf.shape[axis]
            value = value + np.arange(leaf.shape[axis]).reshape(shape)
        marked.append(value)
    return jax.tree_util.tree_unflatten(treedef, marked)


def _varying_dim(t: np.ndarray):
    dims = [d for d in range(t.ndim) if t.shape[d] > 1 and not np.all(np.diff(t, axis=d) == 0)]
    assert len(dims) <= 1, dims
    return dims[0] if dims else None


def test_param_partition_spec_matches_jax():
    """Every decoder and projector entry splits along the dim the JAX rule's
    axis maps to, but two: the projector's first bias (JAX replicates every
    1-D leaf; the port splits it with its outputs, so that each rank adds
    its own slice) and embed_out, which JAX splits along the hidden dim of
    its [V, H] leaf (its rule's comment assumes [H, V]) where the port
    splits the vocabulary, as vocab-parallel CE needs. The tower is
    replicated in the port (the JAX package gathers it before use)."""
    jcfg = JModelConfig(vocab_size=256, hidden_size=64, num_hidden_layers=2, num_attention_heads=8,
                        intermediate_size=256, rotary_pct=0.25,
                        vision=JVision(img_size=28, patch_size=14, embed_dim=32, depth=1, num_heads=2, mlp_ratio=2.0))
    ref = params_to_reference_state_dict(_marked_jax_params(jcfg), jcfg)
    differ = {"vision_embed_tokens.0.bias": (None, 0), "embed_out.weight": (1, 0)}
    checked = 0
    for name, value in ref.items():
        if name.startswith("vision_encoder."):
            assert param_partition_spec(name) is None, name
            continue
        want = _varying_dim(np.asarray(value))
        got = param_partition_spec(name)
        if name in differ:
            assert (want, got) == differ[name], name
        else:
            assert got == want, (name, got, want)
        checked += 1
    assert checked == 4 + 2 * 12 + 4 and param_partition_spec("gpt_neox.layers.0.attention.dense.bias") is None
    assert param_partition_spec("adam.mu.gpt_neox.embed_in.weight") == 0  # the optimizer's moments split alike


@pytest.mark.parametrize("mesh, world, cfg, match", [
    ([2, 2], 1, None, r"grid of 2 x 2 = 4 ranks, but the run has 1"),
    ([3, -1], 4, None, r"grid of 3 x 1 = 3 ranks, but the run has 4"),
    ([1, 3], 3, "tiny", "num_attention_heads = 2"),
    ([1, 2], 2, "odd_vocab", "vocab_size = 511"),
    ([1, 4], 4, "narrow_mlp", "intermediate_size = 6"),
    ([2, 2, 1], 4, None, "expected \\[D, M\\]"),
])
def test_layouts_that_do_not_fit_raise(mesh, world, cfg, match):
    model_cfgs = {"tiny": tiny_cfgs()[1], "odd_vocab": tiny_cfgs(decoder={**MPW.TINY, "vocab_size": 511})[1],
                  "narrow_mlp": tiny_cfgs(decoder={**MPW.TINY, "num_attention_heads": 4, "intermediate_size": 6})[1]}
    with pytest.raises(ValueError, match=match):
        check_layout(mesh, world, model_cfgs.get(cfg))


def test_mesh_shapes_resolve():
    assert resolve_mesh_shape([-1, 2], 4) == (2, 2)
    assert resolve_mesh_shape(None, 3) == (3, 1)
    assert resolve_mesh_shape([4], 4) == (4, 1)
    assert check_layout([1, -1], 2, tiny_cfgs()[1]) == (1, 2)


# --- ranks -------------------------------------------------------------------------------------------------

def _jax_probe(preset: str):
    """tests/mp_worker.py::_tp_step_probe's program on the JAX package's
    (2, 2) mesh in this process, attn_impl "xla", float32 compute: losses,
    trainable parameters (numpy) and the starting parameters."""
    jcfg = JModelConfig(**W.PROBE_MODELS[preset], vision=JVision(**W.PROBE_VISION[preset]),
                        vision_encoder_name="tiny-eva")
    cfg = JTrainConfig(**W.probe_train_kwargs())
    mesh = jmake_mesh((2, 2), ("data", "model"), devices=jax.devices()[:4])
    start = jvl.init_params(jcfg, jax.random.PRNGKey(0))
    tr, fz = split_params(shard_params(start, mesh))
    tx = jbuild(cfg, tr, jschedule(1e-3, 2, 10))
    state = JTrainState(jnp.zeros((), jnp.int32), tr, fz, jset_schedule(tx.init(tr), 0, 0))
    teacher = jax.tree.map(lambda x: x.astype(jnp.bfloat16), tr)
    step = jwindow(jcfg, cfg, tx, n_ce=1, attn_impl="xla", donate=False)
    bsh, wsh = batch_sharding(mesh), NamedSharding(mesh, P(None, "data"))
    lang = jnp.full((jcfg.num_hidden_layers - 1,), 0.5, jnp.float32)
    losses = []
    for s in range(2):
        ce = {k: jax.device_put(v[None], wsh) for k, v in W.example_batch(jcfg, 4, 12, seed=10 + s).items()}
        db = {k: jax.device_put(v, bsh) for k, v in W.example_batch(jcfg, 4, 12, seed=20 + s).items()}
        state, m = step(state, teacher, ce, db, lang)
        losses.append({k: float(m[k]) for k in ("loss", "ce_loss", "distill_loss", "grad_norm")})
    return jcfg, losses, jax.tree.map(np.asarray, state.trainable), jax.tree.map(np.asarray, start)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The starting weights (the tiny model, and the probe's two models from
    PRNGKey(0)); the JAX package's probe on its (2, 2) mesh; then the port's
    groups: the layers on 2 ranks, the model units on 2 ranks [1, 2] and on
    one, the probe windows on 4 ranks [2, 2]."""
    root = str(tmp_path_factory.mktemp("torch_tp"))
    jm, tc = tiny_cfgs()
    params = jax.tree.map(np.asarray, jax_params(jm, seed=0))
    save_task_checkpoint(params_from_jax(params, tc), os.path.join(root, W.INIT_PARAMS))
    jax_runs = {}
    for preset in W.PROBE_MODELS:
        jcfg, losses, trained, start = _jax_probe(preset)
        pc = W.probe_model_cfg(preset)
        save_task_checkpoint(params_from_jax(start, pc), os.path.join(root, f"probe_{preset}.safetensors"))
        jax_runs[preset] = (losses, params_from_jax(trained, pc))
    results = run_groups(root, [(2, "layers", "layers", (1, 2)), (2, "model2", "model", (1, 2)),
                                (1, "model1", "model", (1, 1)), (4, "win_tiny", "windows:tiny", (2, 2)),
                                (4, "win_1b", "windows:1b", (2, 2))])
    return root, params, jax_runs, results


def test_ranks_form_the_grid(runs):
    """Rank r = d * M + m: model peers adjacent, data groups strided; a
    process that runs a grid refuses another. all_reduce_metrics sums over
    the data group (model peers once) and refuses a mesh_shape other than
    the run's."""
    assert all(r["other_grid_raises"] for r in runs[3]["layers"])
    for tag, total in (("layers", [1.0, 2.0, 3.0]), ("model1", [1.0, 2.0, 3.0]), ("win_tiny", [2.0, 4.0, 6.0])):
        assert all(r["metrics_sum"] == total for r in runs[3][tag]), tag
    assert all(r["metrics_other_grid_raises"] for tag in ("layers", "win_tiny") for r in runs[3][tag])
    grid = runs[3]["win_tiny"]
    assert [(r["data_index"], r["model_index"]) for r in grid] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert [r["model_ranks"] for r in grid] == [[0, 1], [0, 1], [2, 3], [2, 3]]
    assert [r["data_ranks"] for r in grid] == [[0, 2], [1, 3], [0, 2], [1, 3]]


@pytest.mark.parametrize("layer", ["mlp", "embedding", "cross_entropy", "layer_parallel_residual_True",
                                   "layer_parallel_residual_False"])
def test_parallel_layers_match_dense(runs, layer):
    for rank in runs[3]["layers"]:
        diffs = rank[layer]
        assert max(diffs.values()) <= LAYER_ATOL, (layer, diffs)


def test_gather_and_eval_match_one_process(runs):
    """gather_to_replicated returns the exact weights;
    greedy tokens of the gathered copy equal one process's, and validate_vqa
    over the two ranks' rows scores the 12 examples once, as one process
    does."""
    two, (one,) = runs[3]["model2"], runs[3]["model1"]
    assert all(r["gather_exact"] for r in two + [one])
    shapes = two[0]["shard_shapes"]
    assert shapes["gpt_neox.layers.0.attention.query_key_value.weight"] == [192, 128]  # 1 of 2 heads (3 x 64 rows)
    assert shapes["gpt_neox.layers.0.attention.dense.weight"] == [128, 64]
    assert shapes["gpt_neox.embed_in.weight"] == shapes["embed_out.weight"] == [256, 128]
    assert shapes["vision_embed_tokens.2.bias"] == [128]
    assert two[0]["tokens"] == two[1]["tokens"] == one["tokens"]
    for r in two:
        assert r["validate"]["n_ex"] == one["validate"]["n_ex"] == 12
        assert r["validate"]["acc"] == pytest.approx(one["validate"]["acc"])
    assert {**two[0]["validate"]["results"], **two[1]["validate"]["results"]} == one["validate"]["results"]


def test_gathered_decode_matches_jax_unsharded(runs):
    """The tokens above against the JAX package's decoder on the same weights."""
    from mafed_tpu.evaluation.decode import make_greedy_decoder as jdecoder

    _, params, _, results = runs
    jm, tc = tiny_cfgs()
    b = W.example_batch(tc, 4, 8, seed=10)
    dec = jdecoder(jm, max_new_tokens=4, eos_token_id=0, dtype=jnp.float32, attn_impl="xla")
    want = np.asarray(dec(jax.tree.map(jnp.asarray, params), {k: jnp.asarray(b[k]) for k in
                                                              ("input_ids", "attention_mask", "pixels")}))
    assert results["model2"][0]["tokens"] == want.tolist()


def _assert_params(root, a, b, atol):
    x, y = (load_safetensors(os.path.join(root, f)) for f in (a, b))
    assert x.keys() == y.keys()
    for k in y:
        np.testing.assert_allclose(x[k].numpy(), y[k].numpy(), atol=atol, rtol=0, err_msg=k)


def test_ce_and_ewc_windows_match_one_process(runs):
    root, _, _, results = runs
    two, (one,) = results["model2"], results["model1"]
    for key in ("ce_window_full", "ce_window_dots"):
        assert two[0][key] == two[1][key]
        for got, want in zip(two[0][key], one[key]):
            for k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=METRIC_RTOL, err_msg=f"{key}:{k}")
    for k, want in one["ewc_window"].items():
        np.testing.assert_allclose(two[0]["ewc_window"][k], want, rtol=METRIC_RTOL, err_msg=k)
    assert one["ewc_window"]["loss"] > one["ce_window_dots"][-1]["loss"] + 1e-3  # the penalty counts
    for name in ("ce_full", "ce_dots", "ewc"):
        _assert_params(root, f"{name}_2.safetensors", f"{name}_1.safetensors", PARAM_ATOL)
    two_f, one_f = (load_safetensors(os.path.join(root, f"fisher_{w}.safetensors")) for w in (2, 1))
    for k in one_f:
        np.testing.assert_allclose(two_f[k].numpy(), one_f[k].numpy(), rtol=FISHER_RTOL,
                                   atol=1e-6 * float(one_f[k].abs().max()), err_msg=k)


def test_remat_policies_bit_equal_under_tp(runs):
    """A policy keeps the rank's partial products: the same numbers as full
    recompute, bit for bit."""
    root, _, _, results = runs
    for r in results["model2"]:
        assert r["ce_window_full"] == r["ce_window_dots"]
    a, b = (load_safetensors(os.path.join(root, f"ce_{p}_2.safetensors")) for p in ("full", "dots"))
    assert all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("preset", list(W.PROBE_MODELS))
def test_probe_windows_match_jax_mesh(runs, preset):
    """Two fused MAFED windows on 4 ranks [2, 2] against the JAX package's
    (2, 2) mesh: the model peers report the same metrics, the losses and
    the gathered parameters within the stated tolerances, and the optimizer
    state comes back from its file exactly."""
    root, _, jax_runs, results = runs
    ranks = results[f"win_{preset}"]
    want_losses, want_params = jax_runs[preset]
    heads = W.PROBE_MODELS[preset]["num_attention_heads"]
    head_dim = W.PROBE_MODELS[preset]["hidden_size"] // heads
    assert all(r["local_qkv_rows"] == 3 * head_dim * heads // 2 for r in ranks)
    assert all(r["losses"] == ranks[0]["losses"] for r in ranks)
    for got, want in zip(ranks[0]["losses"], want_losses):
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=JAX_LOSS_RTOL, atol=JAX_LOSS_ATOL, err_msg=k)
    assert want_losses[1]["distill_loss"] > 0
    got = load_safetensors(os.path.join(root, f"win_{preset}_params.safetensors"))
    for k, w in want_params.items():
        if k in got:
            np.testing.assert_allclose(got[k].numpy(), w.numpy(), atol=JAX_PARAM_ATOL, rtol=0, err_msg=k)
    assert set(got) == {k for k in want_params if not k.startswith("vision_encoder.")}
    assert all(r["opt_roundtrip_max_diff"] == 0.0 and r["n_opt_tensors"] > 0 for r in ranks)
